// Fused ViT attention block, forward and backward, for Hopper (sm_90a):
// kernel K8.
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/attn_block.py: _fwd_kernel via _run_fwd (the forward) and
// _bwd_k1_kernel, _bwd_k2_kernel via _run_bwd (the backward), entry
// attn_block.
//   forward : x [B, N, C], Wqkv [3C, C], bqkv [3C], Wproj [C, C], bproj [C]
//             (torch's Linear layout, read as they are; x's dtype), gamma,
//             beta [C] fp32 -> y = x + proj(attention(qkv(LN(x)))) [B, N, C]
//   backward: the same inputs and dy -> dx in x's dtype and dWqkv, dbqkv,
//             dWproj, dbproj, dgamma, dbeta, fp32 sums over all B*N rows
// Head dim d = C / H in {64, 128}, N <= 1024, bf16 or fp32.
//
// Math and roundings, as the TPU kernel: LN in fp32 (eps, two-pass
// variance, where the TPU takes E[x^2] - mean^2), rounded to x's dtype; qkv
// = xn.Wqkv^T + bqkv summed in fp32 and rounded once; per head P =
// softmax(q.k^T * d^-0.5) in fp32, normalised, rounded for P.V; the
// attention output rounded; y = attn.Wproj^T + bproj + x in fp32, rounded
// once. The backward saves nothing but x: it computes LN, qkv and the
// attention output again, then dattn = dy.Wproj, the attention backward (dS =
// P * (dP - rowsum(dP * P)) * d^-0.5 rounded to x's dtype, as the TPU), dxn =
// dqkv.Wqkv in fp32, the LN backward, dx = dx_LN + dy.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at ViT-B/16
// (N = 197, C = 768, H = 12) the forward does 8NC^2 + 4N^2C = 1.049 GFLOP a
// sample, 0.068 ms at B = 64, against x in and y out, 0.012 ms: bound by
// operations. The backward's products are twice the forward's (0.136 ms at
// B = 64); with the recompute 22NC^2 + 12N^2C (0.189 ms).
//
// Design. The TPU kernel walks one sample a grid step with both weight
// matrices resident in VMEM (4.7 MB in bf16 at ViT-B). A block here has at
// most 227 KB of shared memory: one sample's x alone is 302 KB, and the proj
// product sums over every head. So K8 is a chain of launches over the whole
// [B*N, C] activation, each a hand-written kernel, with the intermediates
// (qkv, the attention output, dattn, dqkv, dxn) in a scratch the wrapper
// allocates and frees; the autograd graph keeps only x:
//   forward : LN1 (row statistics and xn, one warp a row); the qkv GEMM with
//             the bias in its epilogue; the attention core by K1's device
//             code, which reads exactly this packed [B, N, 3C] layout (bf16:
//             short_attention_fwd.cu's wgmma kernel; fp32:
//             fused_attention.cu's); the proj GEMM with bias and residual in
//             its epilogue, rounded once;
//   backward: the same, then dattn = dy.Wproj, K1's backward into the packed
//             dqkv (bf16: short_attention_bwd.cu's; fp32:
//             fused_attention.cu's), dWproj = dy^T.attn and dWqkv =
//             dqkv^T.xn, dxn = dqkv.Wqkv (fp32), the column sums dbproj,
//             dbqkv, dgamma, dbeta, and dx.
// The GEMM (attn_block_gemm_bf16) is one mma.sync m16n8k16 template with fp32
// accumulation, 128 x 128 x 32 tiles, 8 warps of 64 x 32, a ring of four
// tiles in flight by cp.async, two blocks an SM; each operand is read in
// place from either layout (ldmatrix or ldmatrix.trans), so the weights need
// no transposed copy. fp32 inputs take an FMA GEMM (attn_block_gemm_f32) of
// 64 x 64 tiles and keep fp32 precision. Sums over the B*N rows (the weight
// gradients split over K, and the column sums) are written as fp32 slices
// and added by reduce_slices in a fixed order: no atomics, so two runs give
// the same bits.

#define SAICV_ATTENTION_DEVICE_ONLY
#include "fused_attention.cu"
#include "short_attention_bwd.cu"
#include "short_attention_fwd.cu"

namespace k8 {

using saicv::bf16;

// ------------------------------------------------------------ elements

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Four consecutive elements as floats, and back.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&o)[4]) {
  uint2 v;
  v.x = saicv::pack_bf16(o[0], o[1]);
  v.y = saicv::pack_bf16(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = v;
}

// Two consecutive outputs of a GEMM epilogue.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = saicv::pack_bf16(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------- GEMM
//
// C[m, n] = sum_k A(m, k) B(k, n) for k in this block's slice of K. Each
// operand is read in place: element (outer, inner) at p[outer * ld + inner],
// inner contiguous. A "K-major" operand has k as its inner index (A(m, k) =
// a[m * lda + k]; B(k, n) = b[n * ldb + k], i.e. torch's Linear weight in a
// forward product); otherwise k is its outer index. Inner extents are
// multiples of 8 (the wrapper takes C % 64 == 0), so a 16-byte vector is
// either wholly inside or wholly outside the matrix.

struct Operand {
  const void* p;
  long long ld;
};

enum Epilogue {
  kStore = 0,         // out = acc, in the element type
  kBias = 1,          // out = acc + bias[n], rounded once
  kBiasResidual = 2,  // out = acc + bias[n] + resid[m, n], rounded once
  kStoreF32 = 3,      // out (fp32) = acc, slice z at out + z * out_split
};

struct GemmArgs {
  Operand a, b;
  int M, N, K;
  int k_chunk;  // K rows of one blockIdx.z slice, a multiple of the tile depth
  void* out;
  long long ldc, out_split;
  const void* bias;   // [N], the element type
  const void* resid;  // [M, ldc], the element type
};

template <typename T, int EPI>
__device__ __forceinline__ void epilogue2(const GemmArgs& g, int row, int col, float v0,
                                          float v1) {
  if (row >= g.M || col >= g.N) return;
  const long long off = static_cast<long long>(row) * g.ldc + col;
  if (EPI == kStoreF32) {
    store2(static_cast<float*>(g.out) + blockIdx.z * g.out_split + off, v0, v1);
    return;
  }
  if (EPI == kBias || EPI == kBiasResidual) {
    const float2 b = load2(static_cast<const T*>(g.bias) + col);
    v0 += b.x;
    v1 += b.y;
  }
  if (EPI == kBiasResidual) {
    const float2 r = load2(static_cast<const T*>(g.resid) + off);
    v0 += r.x;
    v1 += r.y;
  }
  store2(static_cast<T*>(g.out) + off, v0, v1);
}

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 4;         // tiles in flight: a ring of cp.async copies
constexpr int kGemmThreads = 256;  // 8 warps: 2 along m x 4 along n, 64 x 32 each

// One operand's tile of 128 rows (its m or n) by kBK (k) in shared memory:
// K-major as [128][kBK + 8], else as [kBK][128 + 8]; the padding puts the
// eight rows of an ldmatrix on distinct banks.
template <bool KMAJOR>
struct Tile {
  static constexpr int kElems = KMAJOR ? 128 * (kBK + 8) : kBK * (128 + 8);

  // Start copying the tile whose first m or n is mn0 and first k is k0; zeros
  // past mn_lim and k_end. Two 16-byte vectors a thread.
  static __device__ __forceinline__ void copy(bf16* s, const Operand& op, int mn0, int mn_lim,
                                               int k0, int k_end) {
    const bf16* base = static_cast<const bf16*>(op.p);
#pragma unroll
    for (int i = 0; i < 128 * kBK / 8 / kGemmThreads; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      int outer, inner, off;
      bool valid;
      if (KMAJOR) {
        const int row = v / (kBK / 8), kv = (v % (kBK / 8)) * 8;
        outer = mn0 + row;
        inner = k0 + kv;
        valid = outer < mn_lim && inner < k_end;
        off = row * (kBK + 8) + kv;
      } else {
        const int kr = v / 16, mv = (v % 16) * 8;
        outer = k0 + kr;
        inner = mn0 + mv;
        valid = outer < k_end && inner < mn_lim;
        off = kr * (128 + 8) + mv;
      }
      saicv::cp_async16(s + off, valid ? base + outer * op.ld + inner : base, valid);
    }
  }
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragments (m16 x k16) of the tile rows m..m+15, k-step ks.
template <bool KMAJOR>
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const bf16* s, int m, int ks,
                                       int lane) {
  if (KMAJOR)
    saicv::ldmatrix_x4(f, s + (m + lane % 8 + 8 * ((lane / 8) % 2)) * (kBK + 8) + 16 * ks +
                              8 * (lane / 16));
  else
    saicv::ldmatrix_x4_trans(f, s + (16 * ks + lane % 8 + 8 * (lane / 16)) * (kBM + 8) + m +
                                    8 * ((lane / 8) % 2));
}

// B fragments of two n8 groups (n..n+15), k-step ks: {f[0], f[1]} for
// columns n..n+7, {f[2], f[3]} for n+8..n+15.
template <bool KMAJOR>
__device__ __forceinline__ void b_frags(uint32_t (&f)[4], const bf16* s, int n, int ks,
                                        int lane) {
  if (KMAJOR)
    saicv::ldmatrix_x4(f, s + (n + lane % 8 + 8 * (lane / 16)) * (kBK + 8) + 16 * ks +
                              8 * ((lane / 8) % 2));
  else
    saicv::ldmatrix_x4_trans(f, s + (16 * ks + ((lane / 8) & 1) * 8 + lane % 8) * (kBN + 8) +
                                    n + ((lane / 8) >> 1) * 8);
}

template <bool A_K, bool B_K>
constexpr size_t gemm_bf16_smem() {
  return sizeof(bf16) * kStages * (Tile<A_K>::kElems + Tile<B_K>::kElems);
}

// Two blocks an SM (at most 128 registers a thread, 2 x 80 KB of shared
// memory): while one block waits at its barrier the other's products run.
template <bool A_K, bool B_K, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
attn_block_gemm_bf16(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);           // [kStages][Tile<A_K>::kElems]
  bf16* Bs = As + kStages * Tile<A_K>::kElems;        // [kStages][Tile<B_K>::kElems]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int gq = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto copy_tile = [&](int tile) {
    const int stage = tile % kStages, k0 = k_begin + tile * kBK;
    Tile<A_K>::copy(As + stage * Tile<A_K>::kElems, g.a, m0, g.M, k0, k_end);
    Tile<B_K>::copy(Bs + stage * Tile<B_K>::kElems, g.b, n0, g.N, k0, k_end);
  };
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < tiles) copy_tile(tile);
    saicv::cp_async_commit();  // one group a tile, possibly empty
  }

  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // everyone's copies; tile kt - 1 read by all
    if (kt + kStages - 1 < tiles) copy_tile(kt + kStages - 1);
    saicv::cp_async_commit();
    const bf16* a = As + (kt % kStages) * Tile<A_K>::kElems;
    const bf16* b = Bs + (kt % kStages) * Tile<B_K>::kElems;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a_frag<A_K>(af[i], a, wm + 16 * i, ks, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) b_frags<B_K>(bfr[p], b, wn + 16 * p, ks, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          saicv::mma_16816(acc[i][j], af[i], bfr[j / 2][2 * (j % 2)],
                           bfr[j / 2][2 * (j % 2) + 1]);
    }
  }
  saicv::cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epilogue2<bf16, EPI>(g, m0 + wm + 16 * i + gq + 8 * h, n0 + wn + 8 * j + 2 * t,
                             acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// fp32 inputs: the same products in FMA, 64 x 64 x 16 tiles, 4 x 4 outputs a
// thread, both operands staged as [k][m or n] (a K-major operand transposed
// on the way in).
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <bool KMAJOR, int R>
__device__ __forceinline__ void fetch_f32(float (&r)[4], const Operand& op, int mn0,
                                          int mn_lim, int k0, int k_end) {
  const int v = threadIdx.x;
  long long outer;
  int inner;
  bool valid;
  if (KMAJOR) {
    outer = mn0 + v / (kFK / 4);
    inner = k0 + (v % (kFK / 4)) * 4;
    valid = outer < mn_lim && inner < k_end;
  } else {
    outer = k0 + v / (R / 4);
    inner = mn0 + (v % (R / 4)) * 4;
    valid = outer < k_end && inner < mn_lim;
  }
  if (!valid) {
    r[0] = r[1] = r[2] = r[3] = 0.f;
    return;
  }
  load4(static_cast<const float*>(op.p) + outer * op.ld + inner, r);
}

template <bool KMAJOR, int R>
__device__ __forceinline__ void store_f32(float* s, const float (&r)[4]) {
  const int v = threadIdx.x;
  if (KMAJOR) {
    const int row = v / (kFK / 4), kv = (v % (kFK / 4)) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[(kv + e) * (R + 4) + row] = r[e];
  } else {
    const int kr = v / (R / 4), mv = (v % (R / 4)) * 4;
    *reinterpret_cast<float4*>(s + kr * (R + 4) + mv) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

template <bool A_K, bool B_K, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
attn_block_gemm_f32(GemmArgs g) {
  __shared__ __align__(16) float As[2][kFK * (kFM + 4)];
  __shared__ __align__(16) float Bs[2][kFK * (kFN + 4)];
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int tiles = (k_end - k_begin + kFK - 1) / kFK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float ra[4], rb[4];
  if (tiles > 0) {
    fetch_f32<A_K, kFM>(ra, g.a, m0, g.M, k_begin, k_end);
    fetch_f32<B_K, kFN>(rb, g.b, n0, g.N, k_begin, k_end);
    store_f32<A_K, kFM>(As[0], ra);
    store_f32<B_K, kFN>(Bs[0], rb);
  }
  __syncthreads();
  for (int kt = 0; kt < tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < tiles;
    if (more) {
      fetch_f32<A_K, kFM>(ra, g.a, m0, g.M, k_begin + (kt + 1) * kFK, k_end);
      fetch_f32<B_K, kFN>(rb, g.b, n0, g.N, k_begin + (kt + 1) * kFK, k_end);
    }
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As[cur] + k * (kFM + 4) + 4 * tm);
      const float4 b = *reinterpret_cast<const float4*>(Bs[cur] + k * (kFN + 4) + 4 * tn);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_f32<A_K, kFM>(As[cur ^ 1], ra);
      store_f32<B_K, kFN>(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      epilogue2<float, EPI>(g, m0 + 4 * tm + i, n0 + 4 * tn + j, acc[i][j], acc[i][j + 1]);
}

// ------------------------------------------------------- row kernels
//
// One warp a row of [M, C], four channels a lane at a time; a second walk
// over the row reads it again from L1.

constexpr int kRowWarps = 8;

// LN1 of each row of x: mean and rstd (two-pass variance) in fp32, and xn =
// (x - mean) * rstd * gamma + beta rounded to x's dtype, the qkv product's
// operand.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
attn_block_layer_norm(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ xn,
                      float* __restrict__ mean, float* __restrict__ rstd, long long M, int C,
                      float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + row * C;
  float s = 0.f;
  for (int c = 4 * lane; c < C; c += 128) {
    float v[4];
    load4(xr + c, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
  for (int c = 4 * lane; c < C; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) q += (v[e] - mu) * (v[e] - mu);
  }
  const float rs = rsqrtf(warp_sum(q) / C + eps);
  for (int c = 4 * lane; c < C; c += 128) {
    float v[4], gm[4], bt[4];
    load4(xr + c, v);
    load4(gamma + c, gm);
    load4(beta + c, bt);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (v[e] - mu) * rs * gm[e] + bt[e];
    store4(xn + row * C + c, v);
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// The LayerNorm backward of each row, plus the residual: with g = dxn *
// gamma and xhat = (x - mean) * rstd, dx = rstd * (g - mean(g) - xhat *
// mean(g * xhat)) + dy, rounded once. dxn is fp32.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
attn_block_ln_backward(const T* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const float* __restrict__ gamma,
                       const float* __restrict__ dxn, const T* __restrict__ dy,
                       T* __restrict__ dx, long long M, int C) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const long long off = row * C;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = 4 * lane; c < C; c += 128) {
    float xv[4], dv[4], gm[4];
    load4(x + off + c, xv);
    load4(dxn + off + c, dv);
    load4(gamma + c, gm);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gv = dv[e] * gm[e];
      s1 += gv;
      s2 += gv * ((xv[e] - mu) * rs);
    }
  }
  const float mg = warp_sum(s1) / C, mgx = warp_sum(s2) / C;
  for (int c = 4 * lane; c < C; c += 128) {
    float xv[4], dv[4], gm[4], yv[4], o[4];
    load4(x + off + c, xv);
    load4(dxn + off + c, dv);
    load4(gamma + c, gm);
    load4(dy + off + c, yv);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = rs * (dv[e] * gm[e] - mg - (xv[e] - mu) * rs * mgx) + yv[e];
    store4(dx + off + c, o);
  }
}

// ----------------------------------------------------- column sums
//
// Sums over the rows in a fixed order: a block takes 32 columns and one part
// of kPartRows rows; thread (x, y) adds rows y, y + 8, ... of its column,
// then the 8 sums are added in order and written as row `part` of an fp32
// slice array that reduce_slices adds up.

constexpr int kPartRows = 512;
constexpr int kSumY = 8;

__device__ __forceinline__ void finish_column(float (&part)[kSumY][33], float v, float* out,
                                              int col, int cols) {
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSumY; ++i) s += part[i][threadIdx.x];
    out[static_cast<long long>(blockIdx.y) * cols + col] = s;
  }
  __syncthreads();
}

// partial[part, c] = sum of src[m, c] over the part's rows (the bias
// gradients).
template <typename T>
__global__ void __launch_bounds__(32 * kSumY)
attn_block_column_sums(const T* __restrict__ src, float* __restrict__ partial, long long M,
                       int cols) {
  __shared__ float part[kSumY][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * kPartRows;
  const long long r1 = min(M, r0 + kPartRows);
  float s = 0.f;
  if (col < cols)
    for (long long r = r0 + threadIdx.y; r < r1; r += kSumY) s += to_f(src[r * cols + col]);
  finish_column(part, s, partial, col, cols);
}

// dgamma and dbeta: partial[part, c] = sum dxn * xhat and partial[parts +
// part, c] = sum dxn over the part's rows.
template <typename T>
__global__ void __launch_bounds__(32 * kSumY)
attn_block_ln_param_sums(const T* __restrict__ x, const float* __restrict__ mean,
                         const float* __restrict__ rstd, const float* __restrict__ dxn,
                         float* __restrict__ partial, long long M, int C) {
  __shared__ float part[kSumY][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * kPartRows;
  const long long r1 = min(M, r0 + kPartRows);
  float sg = 0.f, sb = 0.f;
  if (col < C)
    for (long long r = r0 + threadIdx.y; r < r1; r += kSumY) {
      const float d = dxn[r * C + col];
      sg += d * ((to_f(x[r * C + col]) - mean[r]) * rstd[r]);
      sb += d;
    }
  finish_column(part, sg, partial, col, C);
  finish_column(part, sb, partial + static_cast<long long>(gridDim.y) * C, col, C);
}

// out[i] = sum over s of partial[s * n + i], s in order.
__global__ void __launch_bounds__(256)
attn_block_reduce_slices(const float* __restrict__ partial, float* __restrict__ out, int slices,
                         long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += partial[k * n + i];
  out[i] = s;
}

// ------------------------------------------------------------ launchers

struct Shape {
  int B, N, C, H, D;
  long long M;  // B * N rows
  int bf16;
  float eps;
  cudaStream_t stream;
};

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <bool A_K, bool B_K, int EPI>
int gemm(const Shape& s, GemmArgs g, int splits = 1) {
  if (s.bf16) {
    constexpr size_t smem = gemm_bf16_smem<A_K, B_K>();
    const cudaError_t err = allow_smem(attn_block_gemm_bf16<A_K, B_K, EPI>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, splits);
    attn_block_gemm_bf16<A_K, B_K, EPI><<<grid, kGemmThreads, smem, s.stream>>>(g);
  } else {
    const dim3 grid((g.N + kFN - 1) / kFN, (g.M + kFM - 1) / kFM, splits);
    attn_block_gemm_f32<A_K, B_K, EPI><<<grid, kGemmThreads, 0, s.stream>>>(g);
  }
  return last_error();
}

// The split of a weight gradient's K = M rows over blockIdx.z: enough output
// tiles for two waves on 132 SMs, and no slice summing more than kSplitRows
// rows in one accumulator chain (an fp32 chain over all 50,432 rows of a
// ViT-B/16 batch of 256 drifts ~1e-5 of the sum; the slices are added in a
// second pass), each slice whole tiles deep. Depends on the shape alone, so
// the sums' order is fixed.
constexpr int kSplitRows = 4096;

void weight_split(const Shape& s, int rows_out, int cols_out, int& splits, int& k_chunk) {
  const int bm = s.bf16 ? kBM : kFM, bn = s.bf16 ? kBN : kFN, bk = s.bf16 ? kBK : kFK;
  const long long tiles = static_cast<long long>((rows_out + bm - 1) / bm) * ((cols_out + bn - 1) / bn);
  long long want = (2 * 132 + tiles - 1) / tiles;
  const long long by_rows = (s.M + kSplitRows - 1) / kSplitRows;
  if (by_rows > want) want = by_rows;
  const long long k_tiles = (s.M + bk - 1) / bk;
  if (want > k_tiles) want = k_tiles;
  if (want < 1) want = 1;
  k_chunk = static_cast<int>((k_tiles + want - 1) / want) * bk;
  splits = static_cast<int>((s.M + k_chunk - 1) / k_chunk);
}

int parts_of(long long M) { return static_cast<int>((M + kPartRows - 1) / kPartRows); }

int reduce(const Shape& s, const float* partial, float* out, int slices, long long n) {
  attn_block_reduce_slices<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s.stream>>>(
      partial, out, slices, n);
  return last_error();
}

template <typename T>
int column_sums(const Shape& s, const void* src, int cols, float* partial, float* out) {
  const int parts = parts_of(s.M);
  const dim3 grid((cols + 31) / 32, parts);
  attn_block_column_sums<T><<<grid, dim3(32, kSumY), 0, s.stream>>>(
      static_cast<const T*>(src), partial, s.M, cols);
  int err = last_error();
  return err ? err : reduce(s, partial, out, parts, cols);
}

// Workspace, carved in this order, each piece 256-byte aligned: mean, rstd
// [M] fp32; xn [M, C], qkv [M, 3C], attn [M, C]; and for the backward dattn
// [M, C], dqkv [M, 3C] (x's dtype), dxn [M, C] fp32, the attention's
// statistics [2, B, H, N] fp32, and the fp32 slices of the sums (reused by
// each sum in turn).
struct Workspace {
  float *mean, *rstd;
  char *xn, *qkv, *attn, *dattn, *dqkv;
  float *dxn, *att_stats, *partial;
};

long long align256(long long n) { return (n + 255) / 256 * 256; }

long long partial_floats(const Shape& s) {
  int splits, k_chunk;
  long long most = 0;
  weight_split(s, 3 * s.C, s.C, splits, k_chunk);
  most = static_cast<long long>(splits) * 3 * s.C * s.C;
  weight_split(s, s.C, s.C, splits, k_chunk);
  const long long proj = static_cast<long long>(splits) * s.C * s.C;
  const long long cols = static_cast<long long>(parts_of(s.M)) * 3 * s.C;
  if (proj > most) most = proj;
  if (cols > most) most = cols;
  return most;
}

long long workspace_bytes(const Shape& s, bool backward, Workspace* w, char* base) {
  const long long es = s.bf16 ? 2 : 4;
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  Workspace ws{};
  ws.mean = reinterpret_cast<float*>(take(4 * s.M));
  ws.rstd = reinterpret_cast<float*>(take(4 * s.M));
  ws.xn = take(es * s.M * s.C);
  ws.qkv = take(es * s.M * 3 * s.C);
  ws.attn = take(es * s.M * s.C);
  if (backward) {
    ws.dattn = take(es * s.M * s.C);
    ws.dqkv = take(es * s.M * 3 * s.C);
    ws.dxn = reinterpret_cast<float*>(take(4 * s.M * s.C));
    ws.att_stats = reinterpret_cast<float*>(take(4LL * 2 * s.B * s.H * s.N));
    ws.partial = reinterpret_cast<float*>(take(4 * partial_floats(s)));
  }
  if (w) *w = ws;
  return off;
}

// (batch, head, row) strides of q, k, v in the packed qkv, and of the
// attention output
long long packed_sb(const Shape& s) { return static_cast<long long>(s.N) * 3 * s.C; }

template <int DP>
int attention_forward(const Shape& s, const Workspace& w) {
  const long long es = s.bf16 ? 2 : 4;
  const long long c = s.C;
  const float scale = 1.f / sqrtf(static_cast<float>(DP));
  if (s.bf16) {
    const long long st[12] = {packed_sb(s), DP, 3 * c, packed_sb(s), DP, 3 * c,
                              packed_sb(s), DP, 3 * c, s.N * c,      DP, c};
    return saicv::short_attn::fwd::run_plain<DP == 64 ? 0 : 64>(
        w.qkv, w.qkv + c * es, w.qkv + 2 * c * es, w.attn, st, s.B, s.H, s.N, DP, s.N, scale,
        s.stream);
  }
  const Args a = forward_args(w.qkv, w.qkv + c * es, w.qkv + 2 * c * es, w.attn,
                              packed_sb(s), DP, 3 * c, s.N * c, DP, c, s.B, s.H, s.N, DP, s.N,
                              scale, s.stream);
  return launch_dtype<DP>(a, s.bf16);
}

template <int DP>
int attention_backward(const Shape& s, const Workspace& w) {
  const long long es = s.bf16 ? 2 : 4;
  const long long c = s.C;
  const float scale = 1.f / sqrtf(static_cast<float>(DP));
  if (s.bf16) {
    const void* const in[4] = {w.qkv, w.qkv + c * es, w.qkv + 2 * c * es, w.dattn};
    void* const grads[3] = {w.dqkv, w.dqkv + c * es, w.dqkv + 2 * c * es};
    const long long st[15] = {packed_sb(s), DP, 3 * c, packed_sb(s), DP, 3 * c,
                              packed_sb(s), DP, 3 * c, s.N * c,      DP, c,
                              packed_sb(s), DP, 3 * c};
    return saicv::short_attn::bwd::run_plain<DP == 64 ? 0 : 64>(
        in, grads, w.att_stats, st, s.B, s.H, s.N, DP, s.N, scale, s.stream);
  }
  const BwdArgs a = backward_args(
      w.qkv, w.qkv + c * es, w.qkv + 2 * c * es, w.dattn, w.dqkv, w.dqkv + c * es,
      w.dqkv + 2 * c * es, w.att_stats, packed_sb(s), DP, 3 * c, s.N * c, DP, c, packed_sb(s),
      DP, 3 * c, s.B, s.H, s.N, DP, s.N, scale, s.bf16, s.stream);
  return launch_bwd_dtype<DP>(a, s.bf16);
}

struct Weights {
  const void *x, *wqkv, *bqkv, *wproj, *bproj;
  const float *gamma, *beta;
};

// LN1, the qkv product, the attention core: what the forward and the
// backward both compute.
template <typename T>
int qkv_and_attention(const Shape& s, const Weights& p, const Workspace& w) {
  attn_block_layer_norm<T>
      <<<static_cast<unsigned>((s.M + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0,
         s.stream>>>(static_cast<const T*>(p.x), p.gamma, p.beta, reinterpret_cast<T*>(w.xn),
                     w.mean, w.rstd, s.M, s.C, s.eps);
  int err = last_error();
  if (err) return err;
  GemmArgs g{};
  g.a = Operand{w.xn, s.C};
  g.b = Operand{p.wqkv, s.C};
  g.M = static_cast<int>(s.M);
  g.N = 3 * s.C;
  g.K = s.C;
  g.k_chunk = s.C;
  g.out = w.qkv;
  g.ldc = 3 * s.C;
  g.bias = p.bqkv;
  err = gemm<true, true, kBias>(s, g);
  if (err) return err;
  return s.D == 64 ? attention_forward<64>(s, w) : attention_forward<128>(s, w);
}

template <typename T>
int forward(const Shape& s, const Weights& p, void* y, const Workspace& w) {
  int err = qkv_and_attention<T>(s, p, w);
  if (err) return err;
  GemmArgs g{};
  g.a = Operand{w.attn, s.C};
  g.b = Operand{p.wproj, s.C};
  g.M = static_cast<int>(s.M);
  g.N = s.C;
  g.K = s.C;
  g.k_chunk = s.C;
  g.out = y;
  g.ldc = s.C;
  g.bias = p.bproj;
  g.resid = p.x;
  return gemm<true, true, kBiasResidual>(s, g);
}

struct Grads {
  void* dx;
  float *dwqkv, *dbqkv, *dwproj, *dbproj, *dgamma, *dbeta;
};

// dW[o, i] = sum_m G[m, o] X[m, i] over all M rows, split over blockIdx.z
// and added in order: G is [M, rows_out] (K-outer A), X [M, cols_out]
// (K-outer B).
int weight_gradient(const Shape& s, const void* gsrc, Operand xop, int rows_out, int cols_out,
                    float* partial, float* out) {
  int splits, k_chunk;
  weight_split(s, rows_out, cols_out, splits, k_chunk);
  GemmArgs g{};
  g.a = Operand{gsrc, rows_out};
  g.b = xop;
  g.M = rows_out;
  g.N = cols_out;
  g.K = static_cast<int>(s.M);
  g.k_chunk = k_chunk;
  g.out = partial;
  g.ldc = cols_out;
  g.out_split = static_cast<long long>(rows_out) * cols_out;
  int err = gemm<false, false, kStoreF32>(s, g, splits);
  return err ? err : reduce(s, partial, out, splits, g.out_split);
}

template <typename T>
int backward(const Shape& s, const Weights& p, const void* dy, const Grads& d,
             const Workspace& w) {
  int err = qkv_and_attention<T>(s, p, w);
  if (err) return err;
  const int M = static_cast<int>(s.M), C = s.C;
  // dattn = dy . Wproj
  GemmArgs g{};
  g.a = Operand{dy, C};
  g.b = Operand{p.wproj, C};
  g.M = M;
  g.N = C;
  g.K = C;
  g.k_chunk = C;
  g.out = w.dattn;
  g.ldc = C;
  if ((err = gemm<true, false, kStore>(s, g))) return err;
  // the attention backward into the packed dqkv
  if ((err = s.D == 64 ? attention_backward<64>(s, w) : attention_backward<128>(s, w)))
    return err;
  // dWproj = dy^T . attn, dbproj = sum dy
  if ((err = weight_gradient(s, dy, Operand{w.attn, C}, C, C, w.partial, d.dwproj))) return err;
  if ((err = column_sums<T>(s, dy, C, w.partial, d.dbproj))) return err;
  // dWqkv = dqkv^T . xn, dbqkv = sum dqkv
  if ((err = weight_gradient(s, w.dqkv, Operand{w.xn, C}, 3 * C, C, w.partial, d.dwqkv)))
    return err;
  if ((err = column_sums<T>(s, w.dqkv, 3 * C, w.partial, d.dbqkv))) return err;
  // dxn = dqkv . Wqkv (fp32)
  g = GemmArgs{};
  g.a = Operand{w.dqkv, 3 * C};
  g.b = Operand{p.wqkv, C};
  g.M = M;
  g.N = C;
  g.K = 3 * C;
  g.k_chunk = 3 * C;
  g.out = w.dxn;
  g.ldc = C;
  if ((err = gemm<true, false, kStoreF32>(s, g))) return err;
  // dgamma, dbeta; then dx = the LN backward + dy
  const int parts = parts_of(s.M);
  attn_block_ln_param_sums<T><<<dim3((C + 31) / 32, parts), dim3(32, kSumY), 0, s.stream>>>(
      static_cast<const T*>(p.x), w.mean, w.rstd, w.dxn, w.partial, s.M, C);
  if ((err = last_error())) return err;
  if ((err = reduce(s, w.partial, d.dgamma, parts, C))) return err;
  if ((err = reduce(s, w.partial + static_cast<long long>(parts) * C, d.dbeta, parts, C)))
    return err;
  attn_block_ln_backward<T>
      <<<static_cast<unsigned>((s.M + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0,
         s.stream>>>(static_cast<const T*>(p.x), w.mean, w.rstd, p.gamma, w.dxn,
                     static_cast<const T*>(dy), static_cast<T*>(d.dx), s.M, C);
  return last_error();
}

bool bad(int B, int N, int C, int H) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxN || H < 1 || C < 64 || C % H) return true;
  const int D = C / H;
  return (D != 64 && D != 128) || C % 64 != 0 ||
         static_cast<long long>(B) * N > 0x7fffffffLL / (3 * C);
}

Shape shape(int B, int N, int C, int H, float eps, int is_bf16, void* stream) {
  return Shape{B, N, C, H, C / H, static_cast<long long>(B) * N, is_bf16, eps,
               static_cast<cudaStream_t>(stream)};
}

}  // namespace k8

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// x, y, dy, dx, the weights and biases are contiguous and of one dtype
// (is_bf16 = 1: bfloat16, 0: float32); gamma, beta and every gradient but dx
// are float32. `workspace` holds saicv_attn_block_workspace_bytes bytes.
// Each launch function returns a cudaError_t (0 = every kernel launched).

extern "C" long long saicv_attn_block_workspace_bytes(int B, int N, int C, int H, int is_bf16,
                                                      int backward) {
  if (k8::bad(B, N, C, H)) return -1;
  return k8::workspace_bytes(k8::shape(B, N, C, H, 0.f, is_bf16, nullptr), backward != 0,
                             nullptr, nullptr);
}

extern "C" int saicv_attn_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wproj, const void* bproj, const void* gamma,
                                    const void* beta, void* y, void* workspace, int B, int N,
                                    int C, int H, float eps, int is_bf16, void* stream) {
  if (k8::bad(B, N, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  const k8::Shape s = k8::shape(B, N, C, H, eps, is_bf16, stream);
  k8::Workspace w;
  k8::workspace_bytes(s, false, &w, static_cast<char*>(workspace));
  const k8::Weights p{x, wqkv, bqkv, wproj, bproj, static_cast<const float*>(gamma),
                      static_cast<const float*>(beta)};
  return is_bf16 ? k8::forward<saicv::bf16>(s, p, y, w) : k8::forward<float>(s, p, y, w);
}

extern "C" int saicv_attn_block_bwd(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wproj, const void* bproj, const void* gamma,
                                    const void* beta, const void* dy, void* dx, void* dwqkv,
                                    void* dbqkv, void* dwproj, void* dbproj, void* dgamma,
                                    void* dbeta, void* workspace, int B, int N, int C, int H,
                                    float eps, int is_bf16, void* stream) {
  if (k8::bad(B, N, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  const k8::Shape s = k8::shape(B, N, C, H, eps, is_bf16, stream);
  k8::Workspace w;
  k8::workspace_bytes(s, true, &w, static_cast<char*>(workspace));
  const k8::Weights p{x, wqkv, bqkv, wproj, bproj, static_cast<const float*>(gamma),
                      static_cast<const float*>(beta)};
  const k8::Grads d{dx,
                    static_cast<float*>(dwqkv),
                    static_cast<float*>(dbqkv),
                    static_cast<float*>(dwproj),
                    static_cast<float*>(dbproj),
                    static_cast<float*>(dgamma),
                    static_cast<float*>(dbeta)};
  return is_bf16 ? k8::backward<saicv::bf16>(s, p, dy, d, w)
                 : k8::backward<float>(s, p, dy, d, w);
}
