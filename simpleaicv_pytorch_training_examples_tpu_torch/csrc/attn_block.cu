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
// Every bf16 product (qkv, proj; in the backward also dattn, dWproj, dWqkv,
// dxn) runs on one Hopper GEMM, attn_block_gemm_bf16, with fp32
// accumulation: block tiles of 128 x 192 x 64, a producer warp that keeps a
// ring of four stages in flight by TMA (mbarriers), and two consumer
// warpgroups of 64 rows each that run m64n192k16 wgmma from shared-memory
// descriptors; a persistent block walks its output tiles (at ViT-B/16 the
// qkv product's 1,188 tiles are nine waves of 132, the C-wide products'
// 396 three). Each operand is read in place in either layout (wgmma's
// transpose flags take an MN-major A or B), so the weights and the
// activations of the weight gradients need no transposed copy; TMA fills
// zeros past every edge. The epilogue stages each warpgroup's outputs in
// shared memory and writes them by TMA stores, which skip what lies past an
// edge and drain while the next tile's products run. fp32 inputs
// take an FMA GEMM (attn_block_gemm_f32) of 64 x 64 tiles and keep fp32
// precision. Sums over the B*N rows (the weight gradients split over K, and
// the column sums) are written as fp32 slices and added by reduce_slices in
// a fixed order: no atomics, so two runs give the same bits.

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
// C[m, n] = sum_k A(m, k) B(k, n) for k in one slice of K. Each operand is
// read in place: element (outer, inner) at p[outer * ld + inner], inner
// contiguous. A "K-major" operand has k as its inner index (A(m, k) =
// a[m * lda + k]; B(k, n) = b[n * ldb + k], i.e. torch's Linear weight in a
// forward product); otherwise ("MN-major") k is its outer index. Inner
// extents are multiples of 8 elements (the wrapper takes C % 64 == 0), as
// TMA's 16-byte strides and the epilogue's pairs need.

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
  int k_chunk;  // K rows of one slice z, a multiple of the tile depth
  void* out;
  long long ldc, out_split;
  const void* bias;   // [N], the element type
  const void* resid;  // [M, ldc], the element type
};

// Two consecutive outputs (row, col), (row, col + 1) of the fp32 GEMM.
template <int EPI>
__device__ __forceinline__ void epilogue2(const GemmArgs& g, int row, int col, float v0,
                                          float v1) {
  if (row >= g.M || col >= g.N) return;
  const long long off = static_cast<long long>(row) * g.ldc + col;
  float* out = static_cast<float*>(g.out) + off;
  if (EPI == kStoreF32) out += blockIdx.z * g.out_split;
  if (EPI == kBias || EPI == kBiasResidual) {
    const float2 b = load2(static_cast<const float*>(g.bias) + col);
    v0 += b.x;
    v1 += b.y;
  }
  if (EPI == kBiasResidual) {
    const float2 r = load2(static_cast<const float*>(g.resid) + off);
    v0 += r.x;
    v1 += r.y;
  }
  store2(out, v0, v1);
}

// bf16: block tiles of 128 x 192, 64 deep (128 bytes of bf16: the
// 128-byte swizzle). A producer warp keeps a ring of kStages tiles in flight
// by TMA (each stage's A and B tile, completion on the stage's `full`
// mbarrier); two consumer warpgroups each take 64 rows of the tile
// and run m64n192k16 wgmma from shared-memory descriptors into 96 fp32
// registers a thread, one k-tile's group in flight, and free a stage
// (`empty`) once its products are done. The epilogue puts each warpgroup's
// 64 x 192 outputs into its own staging buffer in shared memory (bf16, or
// fp32 in two halves), 128-byte swizzled, and TMA stores it (past an edge
// nothing is written): the next unit's products run while the store drains.
// proj's residual tile comes into the same buffer by TMA first. The block is
// persistent: it walks units u = blockIdx.x, + gridDim.x, ... with u = (z *
// m_tiles + m) * n_tiles + n, so the next unit's loads run during this one's
// epilogue.
constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows of the block tile each
constexpr int kBM = 64 * kConsumers, kBN = 192, kBK = 64;
constexpr int kGemmThreads = 128 * (1 + kConsumers);  // and a producer warpgroup
constexpr int kBox = 64 * 64 * 2;  // bytes of a 64 x 64 bf16 box (a warpgroup's A tile)
constexpr int kATile = kBM * kBK * 2, kBTile = kBN * kBK * 2;
constexpr int kStageBytes = kATile + kBTile;
constexpr int kStaging = 3 * kBox;  // a warpgroup's 64 x 192 bf16 (or 64 x 96 fp32) outputs
// as many 40 KB stages as fit beside the staging, the barriers and the
// alignment in 227 KB: four
constexpr int kStages = (232448 - 1024 - 256 - kConsumers * kStaging) / kStageBytes;
constexpr int kGemmSmem = kStages * kStageBytes + kConsumers * kStaging + 256 + 1024;

// A tile in shared memory, 128-byte swizzled (TMA writes it so): K-major as
// rows of 64 k (128 bytes; a warpgroup's 64 rows one kBox), MN-major as
// kBox boxes of 64 k rows by 64 m or n. The descriptor of k-step kk (16
// deep): K-major 32 bytes along the row; MN-major 16 rows (2048 bytes) down,
// its 64-wide boxes kBox apart.
template <bool KMAJOR>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  return KMAJOR ? saicv::sw128_desc(tile + 32 * kk, 16) : saicv::sw128_desc(tile + 2048 * kk, kBox);
}

// Where the output pair of accumulator registers 4j + 2h, 4j + 2h + 1 lies
// in a warpgroup's staging buffer: row r = 16 warp + lane / 4 + 8h of its 64,
// in three 128-byte-swizzled boxes of 64 rows x 128 bytes (bf16: 64 columns
// a box, all 192 in one pass; fp32: 32 columns a box, columns 96q.. 96q + 95
// in pass q = j / 12).
template <bool F32>
__device__ __forceinline__ uint32_t staged_at(uint32_t buf, int j, int r, int t) {
  if (F32) {
    const int jj = j % 12;
    const int chunk = 2 * (jj & 3) + (t >> 1);
    return buf + (jj >> 2) * kBox + r * 128 + ((chunk ^ (r & 7)) << 4) + 8 * (t & 1);
  }
  return buf + (j >> 3) * kBox + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t;
}

template <bool A_K, bool B_K, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
attn_block_gemm_bf16(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap rmap, const GemmArgs g) {
  using namespace saicv;
  constexpr bool kF32 = EPI == kStoreF32;
  unsigned char* sm = short_attn::aligned_smem();
  unsigned char* staging = sm + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kStaging);
  uint64_t* empty = full + kStages;
  uint64_t* resid_bar = empty + kStages;  // one a consumer warpgroup
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive, with the bytes
      mbar_init(&empty[s], 4 * kConsumers);  // each consumer warp
    }
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mbar_init(&resid_bar[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m_tiles = (g.M + kBM - 1) / kBM, n_tiles = (g.N + kBN - 1) / kBN;
  const int units = m_tiles * n_tiles * ((g.K + g.k_chunk - 1) / g.k_chunk);
  // unit u: its slice z, first row m0 and column n0, and its k-tiles
  auto unit = [&](int u, int& z, int& m0, int& n0, int& k_tiles) {
    n0 = (u % n_tiles) * kBN;
    m0 = (u / n_tiles % m_tiles) * kBM;
    z = u / (n_tiles * m_tiles);
    const int k_begin = z * g.k_chunk;
    k_tiles = (min(g.K - k_begin, g.k_chunk) + kBK - 1) / kBK;
  };

  if (tid < 128) {  // the producer warpgroup; one thread issues the loads
    regs_down<40>();
    if (tid != 0) return;
    int st = 0, parity = 1;  // the ring starts empty
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int z, m0, n0, k_tiles;
      unit(u, z, m0, n0, k_tiles);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int k0 = z * g.k_chunk + kt * kBK;
        mbar_wait(&empty[st], parity);
        unsigned char* a = sm + st * kStageBytes;
        unsigned char* b = a + kATile;
        mbar_expect_tx(&full[st], kStageBytes);  // zeros past an edge count too
        if (A_K) {
          tma_box(a, &amap, &full[st], k0, m0, 0, 0);
        } else {
#pragma unroll
          for (int w = 0; w < kBM / 64; ++w) tma_box(a + w * kBox, &amap, &full[st], m0 + 64 * w, k0, 0, 0);
        }
        if (B_K) {
          tma_box(b, &bmap, &full[st], k0, n0, 0, 0);
        } else {
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j) tma_box(b + j * kBox, &bmap, &full[st], n0 + 64 * j, k0, 0, 0);
        }
        if (++st == kStages) {
          st = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  regs_up<232>();
  const int wg = tid / 128 - 1, tw = tid % 128, warp = tw / 32, lane = tid % 32;
  const int t = lane % 4;
  const uint32_t ring = smem_addr(sm);
  unsigned char* buf = staging + wg * kStaging;
  const uint32_t buf_at = smem_addr(buf);
  const int r = 16 * warp + lane / 4;  // this thread's rows r, r + 8 of the warpgroup's 64
  float acc[kBN / 2];
  int st = 0, parity = 0, resid_parity = 0;
  // the k-tile in stage `stage`: this warpgroup's 64 rows of A times B
  auto products = [&](int stage, bool first) {
    const uint32_t a = ring + stage * kStageBytes + wg * kBox, b = ring + stage * kStageBytes + kATile;
    if (first)
      wgmma_ss192_first<!A_K, !B_K>(acc, operand_desc<A_K>(a, 0), operand_desc<B_K>(b, 0));
    else
      wgmma_ss192<!A_K, !B_K>(acc, operand_desc<A_K>(a, 0), operand_desc<B_K>(b, 0), 1);
#pragma unroll
    for (int kk = 1; kk < kBK / 16; ++kk)
      wgmma_ss192<!A_K, !B_K>(acc, operand_desc<A_K>(a, kk), operand_desc<B_K>(b, kk), 1);
    wg_commit();
  };
  auto advance = [&]() {
    if (++st == kStages) {
      st = 0;
      parity ^= 1;
    }
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int z, m0, n0, k_tiles;
    unit(u, z, m0, n0, k_tiles);
    mbar_wait(&full[st], parity);
    wg_fence();
    products(st, true);
    int prev = st;
    advance();
    for (int kt = 1; kt < k_tiles; ++kt) {
      mbar_wait(&full[st], parity);
      wg_fence();
      products(st, false);
      wg_wait_one();  // the previous k-tile's products are done: free its stage
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      prev = st;
      advance();
    }
    wg_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // The epilogue. Register i of a thread is row r + 8 ((i >> 1) & 1),
    // column 8 (i >> 2) + 2t + (i & 1) of the warpgroup's 64 x 192.
    const int row0 = m0 + 64 * wg;
    if (tw == 0) {
      bulk_wait_read();  // the last unit's store has read the buffer
      if (EPI == kBiasResidual) {
        mbar_expect_tx(&resid_bar[wg], kStaging);
#pragma unroll
        for (int b = 0; b < 3; ++b) tma_box(buf + b * kBox, &rmap, &resid_bar[wg], n0 + 64 * b, row0, 0, 0);
      }
    }
    if (EPI == kBias || EPI == kBiasResidual)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < g.N) {
          const float2 bias = load2(static_cast<const bf16*>(g.bias) + col);
          acc[4 * j] += bias.x;
          acc[4 * j + 1] += bias.y;
          acc[4 * j + 2] += bias.x;
          acc[4 * j + 3] += bias.y;
        }
      }
    if (EPI == kBiasResidual) {
      mbar_wait(&resid_bar[wg], resid_parity);
      resid_parity ^= 1;
    } else {
      named_sync(1 + wg, 128);  // the buffer is free
    }
#pragma unroll
    for (int q = 0; q < (kF32 ? 2 : 1); ++q) {
      if (q > 0) {  // fp32: the first half's store has read the buffer
        if (tw == 0) bulk_wait_read();
        named_sync(1 + wg, 128);
      }
#pragma unroll
      for (int j = 12 * q; j < (kF32 ? 12 * q + 12 : kBN / 8); ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t at = staged_at<kF32>(buf_at, j, r + 8 * h, t);
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (kF32) {
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(v0), "f"(v1) : "memory");
          } else {
            if (EPI == kBiasResidual) {
              uint32_t packed;
              asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(packed) : "r"(at) : "memory");
              const float2 res = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&packed));
              v0 += res.x;
              v1 += res.y;
            }
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(v0, v1)) : "memory");
          }
        }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (tw == 0) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          tma_store_box(&cmap, buf + b * kBox, kF32 ? n0 + 96 * q + 32 * b : n0 + 64 * b, row0, z, 0);
        bulk_commit();
      }
    }
  }
  if (tw == 0) bulk_wait();  // the stores have completed before the block ends
}

// fp32 inputs: the same products in FMA, 64 x 64 x 16 tiles, 4 x 4 outputs a
// thread, both operands staged as [k][m or n] (a K-major operand transposed
// on the way in), slice z = blockIdx.z.
constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kF32Threads = 256;

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
__global__ void __launch_bounds__(kF32Threads)
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
      epilogue2<EPI>(g, m0 + 4 * tm + i, n0 + 4 * tn + j, acc[i][j], acc[i][j + 1]);
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

// A GEMM's 128-byte-swizzled tensor map of D x N elements (rows sn apart;
// H slices sh apart, B = 1 of make_map's 4-D maps: an axis of size 1 is
// never read), bf16 or fp32, boxes of box_cols x box_rows.
bool gemm_map(CUtensorMap* map, const void* base, long long sh, long long sn, int H, int N, int D,
              int box_cols, int box_rows, bool f32) {
  return saicv::make_map(map, base, 0, sh, sn, 1, H, N, D, box_cols, box_rows,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// The 2-D tensor map of a bf16 GEMM operand: K-major boxes of 64 k by
// `rows` (the block tile's m or n), MN-major boxes of 64 (m or n) by 64 k.
bool operand_map(CUtensorMap* map, const Operand& op, bool kmajor, int mn, int K, int rows) {
  return kmajor ? gemm_map(map, op.p, 0, op.ld, 1, mn, K, 64, rows, false)
                : gemm_map(map, op.p, 0, op.ld, 1, K, mn, 64, 64, false);
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 132;
  return sms;
}

// One product over slices of g.k_chunk rows of K (one slice when k_chunk
// >= K); the slices' count is ceil(K / k_chunk).
template <bool A_K, bool B_K, int EPI>
int gemm(const Shape& s, GemmArgs g) {
  const int splits = (g.K + g.k_chunk - 1) / g.k_chunk;
  if (s.bf16) {
    // the output's map: bf16 boxes of 64 x 64, or fp32 boxes of 32 columns
    // x 64 rows with the slices z as a third axis; the residual's (read by
    // kBiasResidual alone) as a bf16 output's
    CUtensorMap amap, bmap, cmap, rmap;
    const bool f32 = EPI == kStoreF32;
    if (!operand_map(&amap, g.a, A_K, g.M, g.K, kBM) || !operand_map(&bmap, g.b, B_K, g.N, g.K, kBN) ||
        !gemm_map(&cmap, g.out, g.out_split, g.ldc, splits, g.M, g.N, f32 ? 32 : 64, 64, f32) ||
        (EPI == kBiasResidual && !gemm_map(&rmap, g.resid, 0, g.ldc, 1, g.M, g.N, 64, 64, false)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (EPI != kBiasResidual) rmap = cmap;
    const cudaError_t err = allow_smem(attn_block_gemm_bf16<A_K, B_K, EPI>, kGemmSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long units = static_cast<long long>((g.M + kBM - 1) / kBM) *
                            ((g.N + kBN - 1) / kBN) * splits;
    const int sms = sm_count();
    const unsigned grid = static_cast<unsigned>(units < sms ? units : sms);
    attn_block_gemm_bf16<A_K, B_K, EPI>
        <<<grid, kGemmThreads, kGemmSmem, s.stream>>>(amap, bmap, cmap, rmap, g);
  } else {
    const dim3 grid((g.N + kFN - 1) / kFN, (g.M + kFM - 1) / kFM, splits);
    attn_block_gemm_f32<A_K, B_K, EPI><<<grid, kF32Threads, 0, s.stream>>>(g);
  }
  return last_error();
}

// The split of a weight gradient's sum over K = B*N rows into fp32 slices,
// each whole tiles deep and no deeper than kSplitRows rows (an fp32 chain
// over all 50,432 rows of a ViT-B/16 batch of 256 drifts ~1e-5 of the sum;
// the slices are added in a second pass, in order). fp32: enough output
// tiles for two waves on 132 SMs. bf16: the count that should finish
// soonest on 132 SMs at the card's peak rates (989 TFLOP/s, 3.35 TB/s): the
// rounds of units times a unit's k-tiles, plus each slice's write and read
// in device memory (rows_out x cols_out x 8 bytes) counted in the time of
// one block's k-tile. Depends on the shape alone, so the sums' order is
// fixed.
constexpr int kSplitRows = 4096;

void weight_split(long long K, int rows_out, int cols_out, bool bf16, int& splits,
                  int& k_chunk) {
  const int bm = bf16 ? kBM : kFM, bn = bf16 ? kBN : kFN, bk = bf16 ? kBK : kFK;
  const long long tiles = static_cast<long long>((rows_out + bm - 1) / bm) * ((cols_out + bn - 1) / bn);
  const long long k_tiles = (K + bk - 1) / bk;
  const long long by_rows = (K + kSplitRows - 1) / kSplitRows;
  long long depth;  // k-tiles a slice
  if (!bf16) {
    long long want = (2 * 132 + tiles - 1) / tiles;
    if (by_rows > want) want = by_rows;
    if (want > k_tiles) want = k_tiles;
    if (want < 1) want = 1;
    depth = (k_tiles + want - 1) / want;
  } else {
    const double tile_bytes = 2.0 * kBM * kBN * kBK * 132 / 989e12 * 3.35e12;
    const double slice_cost = static_cast<double>(rows_out) * cols_out * 8.0 / tile_bytes;
    double best = -1.0;
    depth = k_tiles;
    for (long long want = by_rows > 1 ? by_rows : 1; want <= k_tiles; ++want) {
      const long long d = (k_tiles + want - 1) / want;
      if (d * bk > kSplitRows) continue;
      const long long slices = (k_tiles + d - 1) / d;
      const double cost = static_cast<double>((tiles * slices + 131) / 132 * d) + slices * slice_cost;
      if (best < 0.0 || cost < best) {
        best = cost;
        depth = d;
      }
    }
  }
  k_chunk = static_cast<int>(depth * bk);
  splits = static_cast<int>((K + k_chunk - 1) / k_chunk);
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
  weight_split(s.M, 3 * s.C, s.C, s.bf16, splits, k_chunk);
  most = static_cast<long long>(splits) * 3 * s.C * s.C;
  weight_split(s.M, s.C, s.C, s.bf16, splits, k_chunk);
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

// dW[o, i] = sum_m G[m, o] X[m, i] over K rows m, in fp32 slices
// (weight_split) added in order: G is [K, rows_out] (MN-major A), X [K,
// cols_out] (MN-major B).
int weight_gradient(const Shape& s, long long K, const void* gsrc, Operand xop, int rows_out,
                    int cols_out, float* partial, float* out) {
  int splits, k_chunk;
  weight_split(K, rows_out, cols_out, s.bf16, splits, k_chunk);
  GemmArgs g{};
  g.a = Operand{gsrc, rows_out};
  g.b = xop;
  g.M = rows_out;
  g.N = cols_out;
  g.K = static_cast<int>(K);
  g.k_chunk = k_chunk;
  g.out = partial;
  g.ldc = cols_out;
  g.out_split = static_cast<long long>(rows_out) * cols_out;
  int err = gemm<false, false, kStoreF32>(s, g);
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
  if ((err = weight_gradient(s, s.M, dy, Operand{w.attn, C}, C, C, w.partial, d.dwproj)))
    return err;
  if ((err = column_sums<T>(s, dy, C, w.partial, d.dbproj))) return err;
  // dWqkv = dqkv^T . xn, dbqkv = sum dqkv
  if ((err = weight_gradient(s, s.M, w.dqkv, Operand{w.xn, C}, 3 * C, C, w.partial, d.dwqkv)))
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

// One bf16 product of K8's GEMM alone, for its tests: a is [M, K] (a_kmajor
// = 1) or [K, M], b [N, K] (b_kmajor = 1) or [K, N], out [M, N], all
// contiguous, at the layouts and epilogues K8 runs: qkv (1, 1, kBias), proj
// (1, 1, kBiasResidual), dattn (1, 0, kStore), dxn (1, 0, kStoreF32), and
// the weight gradients (0, 0, epilogue 4: fp32 slices over K added in order
// into out, with saicv_attn_block_gemm_workspace_bytes of workspace). bias
// is [N], resid [M, N]; every inner extent a multiple of 8. Returns a
// cudaError_t (cudaErrorInvalidValue for another layout or shape).

extern "C" long long saicv_attn_block_gemm_workspace_bytes(int M, int N, int K) {
  if (M < 1 || N < 1 || K < 1) return -1;
  int splits, k_chunk;
  k8::weight_split(K, M, N, true, splits, k_chunk);
  return 4LL * splits * M * N;
}

extern "C" int saicv_attn_block_gemm(const void* a, int a_kmajor, const void* b, int b_kmajor,
                                     int M, int N, int K, int epilogue, const void* bias,
                                     const void* resid, void* out, void* workspace, void* stream) {
  using namespace k8;
  const long long inner_a = a_kmajor ? K : M, inner_b = b_kmajor ? K : N;
  if (M < 1 || N < 1 || K < 1 || inner_a % 8 || inner_b % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{};
  s.bf16 = 1;
  s.stream = static_cast<cudaStream_t>(stream);
  if (!a_kmajor && !b_kmajor && epilogue == 4)
    return weight_gradient(s, K, a, Operand{b, N}, M, N, static_cast<float*>(workspace),
                           static_cast<float*>(out));
  GemmArgs g{};
  g.a = Operand{a, inner_a};
  g.b = Operand{b, inner_b};
  g.M = M;
  g.N = N;
  g.K = K;
  g.k_chunk = K;
  g.out = out;
  g.ldc = N;
  g.bias = bias;
  g.resid = resid;
  if (a_kmajor && b_kmajor && epilogue == kBias) return gemm<true, true, kBias>(s, g);
  if (a_kmajor && b_kmajor && epilogue == kBiasResidual)
    return gemm<true, true, kBiasResidual>(s, g);
  if (a_kmajor && !b_kmajor && epilogue == kStore) return gemm<true, false, kStore>(s, g);
  if (a_kmajor && !b_kmajor && epilogue == kStoreF32) return gemm<true, false, kStoreF32>(s, g);
  return static_cast<int>(cudaErrorInvalidValue);
}
