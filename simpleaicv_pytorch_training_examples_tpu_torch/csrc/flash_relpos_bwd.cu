// Backward of kernel K5 (streaming attention with SAM's decomposed
// relative-position bias) in bf16, for Hopper (sm_90a): wgmma products on
// TMA-fed tiles, in two walks with no atomics.
//
// Replaces, for bf16 inputs, the TPU (Pallas) kernel _bwd_rel_fused_kernel
// of the JAX package's ops/pallas/flash_attention.py (via
// _flash_rel_backward, entry flash_attention_relpos); the fp32 backward
// keeps its FMA kernels in flash_attention.cu. q, k, v and dO [B, H, N, D]
// (each with its own strides, head dim contiguous, read in place through
// TMA tensor maps), rel_h [B, H, N, KH] and rel_w [B, H, N, KW] fp32 (N = KH
// * KW), the forward's fp32 log-sum-exp and delta = rowsum(dO * O) (the
// wrapper's one torch op, as the JAX package computes it outside its
// kernel) -> dq, dk, dv in bf16 and drel_h, drel_w in fp32. The score of
// query i and key j = jh * KW + jw is q_i.k_j * scale + rel_h[i, jh] +
// rel_w[i, jw].
//
// Math, the TPU kernel's: P = 2^(s * scale * log2(e) + (rel_h + rel_w) *
// log2(e) - lse * log2(e)) from the fp32 scores; dS0 = P * (dP - delta) in
// fp32; drel_h and drel_w the fp32 sums of dS0 over each key-grid row and
// column; dS0 rounded to bf16 for dQ = dS0.K and dK = dS0^T.Q, the scale
// applied after the products; dV = bf16(P)^T.dO. Keys past N get P = 0.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at SAM-B's
// global blocks ([8, 12, 4096, 64], KH = KW = 64) the five N x N x D
// products are 10 * B * H * N^2 * D = 1.03 TFLOP = 1.04 ms, against ~0.3
// GB of q, k, v, dO, the gradients and the fp32 rel terms (0.09 ms): bound
// by operations. This design computes seven products, not five: S and dP
// in each walk, so that dQ and drel_w need no sum across blocks.
//
// Design.
//   - Two walks, two kernels, no atomics: every output element is written
//     by one thread in a fixed order, so two runs give the same bits.
//       dQ walk:    S = Q.K^T, dP = dO.V^T, P, dS0; dQ += bf16(dS0).K; drel.
//       dK/dV walk: S^T = K.Q^T, dP^T = V.dO^T, P^T, dS0^T;
//                   dV += bf16(P^T).dO, dK += bf16(dS0^T).Q.
//   - A block owns 128 rows (queries, or keys) of one (batch, head): two
//     consumer warpgroups of 64 rows each and a producer warpgroup (384
//     threads) of which one warp works and which gives its registers to
//     the consumers (setmaxnreg 40 / 232). The producer warp loads both
//     warpgroups' own tiles once (Q and dO, or K and V), then streams the
//     other pair (K and V, or Q and dO) through a ring of stages with full
//     and empty mbarriers: 4 stages at D <= 80, 3 at 128, 2 at 192 (1 in
//     the dK/dV walk with any KW), 1 at 256. The two warpgroups share every
//     streamed tile and run on their own, one's exponentials beside the
//     other's products.
//   - Tiles are 64 rows x 64 columns of bf16 in the 128-byte swizzle that
//     TMA writes and wgmma reads; D in (64, 80] (SAM-H) takes its columns
//     64-79 in a box of 16 columns in the 32-byte swizzle, one more k-step
//     and an n = 16 product, as flash_attention_fwd.cu does (not padded to
//     128). One copy of each streamed tile feeds both of its products: read
//     K-major by the score products and MN-major (the descriptor's
//     transpose bit) by the gradient products, so nothing is transposed.
//     The two warpgroups do not take turns (as flash_attention_fwd.cu's
//     do): each waits for its own products, and the other's fill the gap.
//   - Every product reads its operands from shared memory (score
//     products K-major, gradient products MN-major), but for the gradient
//     products' A, P and dS0, which come from registers in the
//     accumulator layout. Register-A score products, with the own tiles'
//     fragments held in registers for the whole walk, timed within 1% of
//     these on one H100 SXM at SAM-B's shape, and in the dQ walk at D = 64
//     ptxas gave dO's fragment registers to other values inside the walk,
//     so that every tile after the first multiplied the wrong A: not
//     taken. D > 80 (off SAM's paths): the
//     output columns in chunks of 64 over the grid, each chunk recomputing
//     S and dP over the whole head dim.
//   - Key-grid mode (KW = 64, D <= 80, KH <= 128: SAM-B, SAM-H). A 64-key
//     tile is exactly one key-grid row jh.
//       dQ walk: the thread's rel_w values (16 columns of 2 rows) stay in
//       registers for the whole walk at D = 64 (at D = 80 the block's rel_w
//       rows are staged once, for want of registers), the block's rel_h
//       rows [128 x KH] are staged once; drel_h[i, jh] is the tile's row sum
//       of the fp32 dS0 (quad shuffles, one store a tile); drel_w
//       accumulates in registers over the walk, in key order, and is
//       written once at the end. drel_h and drel_w need no zero fill.
//       dK/dV walk: a warpgroup's 64 keys are one grid row, so both
//       warpgroups read the same [64 queries x 64] rel_w tile of each query
//       tile: one TMA load of 16 KB a stage (two 32-column fp32 boxes in the
//       128-byte swizzle, read in the S^T accumulator layout without bank
//       conflicts), beside the stage's lse, delta and each warpgroup's rel_h
//       column, which the producer warp writes.
//   - Any other KW (off SAM's paths): the dQ walk reads rel_h and rel_w of
//     every score through L1, puts each tile's fp32 dS0 in shared memory,
//     and thread r (r + 64) of a warpgroup adds row r's terms into its
//     drel_h (drel_w) row in device memory, which it alone touches, in key
//     order (it zeroes the row first). The dK/dV walk's warpgroup builds
//     each query tile's [64 x 64] bias tile in shared memory while its
//     score products run (read through L1 into each thread's registers,
//     the loads' addresses spilled).
//   Shared memory: dQ walk at D = 64 96 KB of tiles + 32 KB of rel_h rows;
//   dK/dV walk 32 KB of own tiles + 4 stages of 33 KB.
//
// The tensor maps need libcuda's cuTensorMapEncodeTiled, fetched through
// the runtime (hopper.cuh), so nothing links against libcuda. The wrapper
// copies an operand whose base or strides TMA cannot read before the call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace saicv;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlockRows = 128;             // rows a block
constexpr int kBox = 64 * 64 * 2;           // bytes of one 64 x 64 bf16 box
constexpr int kTailBox = 64 * 16 * 2;       // the 16-column box of D in (64, 80]
constexpr int kRelTile = 64 * 64 * 4;       // a [64 x 64] fp32 rel_w tile
constexpr int kTermBytes = 256 * 4;         // a dK/dV stage's row terms
constexpr int kRwLD = 72;                   // floats a staged rel_w row (dQ walk, D = 80)
constexpr int kDsLD = 65;                   // floats a row of a dS0 tile (any KW)
constexpr int kMaxSmem = 227 * 1024;

constexpr int kBarWg = 1;  // + warpgroup: within one warpgroup (0 is __syncthreads)

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;      // boxes of 64 x 64, 128-byte swizzle
  CUtensorMap q_tail, k_tail, v_tail, do_tail;  // D in (64, 80]: 16 x 64, 32-byte swizzle
  CUtensorMap w_map;                            // key-grid mode: rel_w, fp32 boxes of 32 x 64
  const float* lse;                             // [B * H, N], natural log
  const float* delta;                           // [B * H, N]
  RelPos rel;
  RelGrad drel;
  bf16 *dq, *dk, *dv;                           // one set of strides
  long long o_sb, o_sh, o_sn;
  int B, H, N, D;
  int tiles;   // 64-row tiles of N
  int chunks;  // output column chunks: 1 at D <= 80, else one a 64 columns
  int out_vec;
  float scale;
};

// The stages of a ring and a 64-row tile's bytes, by head-dim shape.
template <int kBlk, int kTail>
struct Tiles {
  static constexpr int kTile = kBlk * kBox + (kTail ? kTailBox : 0);
  static constexpr int kStages = kBlk == 1 ? 4 : kBlk == 2 ? 3 : kBlk == 3 ? 2 : 1;
};

// Byte offsets in the dQ walk's dynamic shared memory (1024-byte aligned):
// the own tiles (Q, dO of warpgroup 0, then of 1), the ring of (K, V)
// stages, the barriers, then (key-grid mode) the rel_h rows [128][KH] and at
// D = 80 the rel_w rows [128][kRwLD], or (any KW) each warpgroup's dS0 tile
// [64][kDsLD].
template <int kBlk, int kTail>
struct QLayout {
  using T = Tiles<kBlk, kTail>;
  static constexpr int kStage = 2 * T::kTile;
  static constexpr int kRing = 4 * T::kTile;
  static constexpr int kBars = kRing + T::kStages * kStage;
  static constexpr int kExtra = kBars + 256;
};

// The dK/dV walk's: the own tiles (K, V of warpgroup 0, then of 1), the
// ring of stages (Q, dO, in key-grid mode the rel_w tile, then the row
// terms: lse * log2(e), delta, each warpgroup's rel_h * log2(e)), the
// barriers, (any KW) each warpgroup's bias tile.
template <int kBlk, int kTail, bool kGrid>
struct KLayout {
  using T = Tiles<kBlk, kTail>;
  // any KW at D = 192: one stage, which leaves room for the bias tiles
  static constexpr int kStages = !kGrid && kBlk == 3 ? 1 : T::kStages;
  static constexpr int kRelAt = 2 * T::kTile;  // in a stage
  static constexpr int kTermsAt = kRelAt + (kGrid ? kRelTile : 0);
  static constexpr int kStage = kTermsAt + kTermBytes;
  static constexpr int kRing = 4 * T::kTile;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kBias = kBars + 256;  // any KW: each warpgroup's bias tile [64][kDsLD]
  static constexpr int kBytes = kBias + (kGrid ? 0 : 2 * 64 * kDsLD * 4);
};

struct Bars {
  uint64_t* own;  // the block's own tiles
  uint64_t* full;  // arrived on by the producer warp's 32 lanes (lane 0 with the bytes)
  uint64_t* empty;

  __device__ __forceinline__ Bars(unsigned char* at, int stages) {
    own = reinterpret_cast<uint64_t*>(at);
    full = own + 1;
    empty = full + stages;
  }
  __device__ __forceinline__ void init(int stages) {
    mbar_init(own, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The block's dynamic shared memory from its first 1024-byte boundary, as
// an offset into the shared array (loads through it stay in the shared
// space).
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
}

// A 64-row tile at (row, head, batch): kBlk boxes of 64 columns and the
// tail box.
template <int kBlk, int kTail>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         const CUtensorMap* tail, uint64_t* bar, int row, int head,
                                         int batch) {
#pragma unroll
  for (int c = 0; c < kBlk; ++c) tma_box(dst + c * kBox, map, bar, 64 * c, row, head, batch);
  if constexpr (kTail > 0) tma_box(dst + kBlk * kBox, tail, bar, 64 * kBlk, row, head, batch);
}

// The producer warp's walk: every tile j < tiles into the ring in order;
// load(stage, j, lane) writes the lane's share of the stage's row terms
// and, on lane 0, arms the stage's full barrier and starts its TMA loads.
template <int kStages, typename Load>
__device__ __forceinline__ void produce(Bars& bars, int tiles, Load load) {
  const int lane = threadIdx.x % 32;
  int stage = 0, parity = 1;  // the ring starts empty
  for (int j = 0; j < tiles; ++j) {
    if (lane == 0) mbar_wait(&bars.empty[stage], parity);
    __syncwarp();
    load(stage, j, lane);
    if (lane != 0) mbar_arrive(&bars.full[stage]);
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }
}

// ------------------------------------------------------------- tile math
//
// Accumulator layout of a 64 x N product in a warpgroup: warp w holds rows
// 16w.. 16w+15; register i of a thread (lane = 4g + t) is row 16w + g + 8 *
// ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1).

// s (64 x 64) = A (64 x D) . B (64 x D)^T over the whole head dim, both
// tiles K-major in shared memory; issued, not committed. The first k-step
// takes s as an output only, so that s is not live between the tiles.
template <int kBlk, int kTail>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int c = 0; c < kBlk; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(a + c * kBox + 32 * kk, 16);
      const uint64_t db = sw128_desc(b + c * kBox + 32 * kk, 16);
      if (c == 0 && kk == 0)
        wgmma_ss_first(s, da, db);
      else
        wgmma_ss<64, 0>(s, da, db, 1);
    }
  if constexpr (kTail > 0)
    wgmma_ss<64, 0>(s, sw32_desc(a + kBlk * kBox), sw32_desc(b + kBlk * kBox), 1);
}

// A 64 x 64 fp32 accumulator tile as the bf16 A fragments of its four
// 16-column k-steps.
__device__ __forceinline__ void pack(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    settle(a[kk]);
  }
}

// acc (64 x 64) and acct (64 x kTail) += A (64 x 64 rows of the streamed
// tile, bf16 registers) . X[:, col0 .. col0 + 63] (and the tail box), X a
// 64-row tile read MN-major; issued, not committed.
template <int kBlk, int kTail>
__device__ __forceinline__ void times_tile(float (&acc)[32], float (&acct)[kTail ? kTail / 2 : 1],
                                           const uint32_t (&a)[4][4], uint32_t x, int col0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<64>(acc, a[kk], sw128_desc(x + (col0 / 64) * kBox + 16 * 128 * kk, kBox), 1);
    if constexpr (kTail == 16) wgmma_rs<16>(acct, a[kk], sw32_desc(x + kBlk * kBox + 16 * 32 * kk), 1);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// ------------------------------------------------------------- dQ walk
//
// Block (query block of 128 rows, output column chunk) of one (batch,
// head): the key tiles 0 .. tiles - 1 in order. Chunk 0 writes drel.
template <int kBlk, int kTail, bool kGrid>
__device__ __forceinline__ void dq_walk(const BwdParams& p) {
  using T = Tiles<kBlk, kTail>;
  using L = QLayout<kBlk, kTail>;
  constexpr int kStages = T::kStages;
  constexpr bool kRwRegs = kGrid && kTail == 0;  // else the rel_w rows are staged
  constexpr int kAccT = kTail ? kTail / 2 : 1;
  unsigned char* sm = aligned_smem();
  Bars bars(sm + L::kBars, kStages);

  const int chunk = blockIdx.x % p.chunks, qb = blockIdx.x / p.chunks;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int q0 = kBlockRows * qb;
  const int tid = threadIdx.x;

  if (tid == 0) bars.init(kStages);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; its first warp loads
    regs_down<40>();
    if (tid >= kConsumers + 32) return;
    if (tid == kConsumers) {
      mbar_expect_tx(bars.own, 4 * T::kTile);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        tma_tile<kBlk, kTail>(sm + 2 * w * T::kTile, &p.q_map, &p.q_tail, bars.own, q0 + 64 * w,
                              hy, bz);
        tma_tile<kBlk, kTail>(sm + (2 * w + 1) * T::kTile, &p.do_map, &p.do_tail, bars.own,
                              q0 + 64 * w, hy, bz);
      }
    }
    produce<kStages>(bars, p.tiles, [&](int st, int j, int lane) {
      if (lane == 0) {
        unsigned char* dst = sm + L::kRing + st * L::kStage;
        mbar_expect_tx(&bars.full[st], L::kStage);
        tma_tile<kBlk, kTail>(dst, &p.k_map, &p.k_tail, &bars.full[st], 64 * j, hy, bz);
        tma_tile<kBlk, kTail>(dst + T::kTile, &p.v_map, &p.v_tail, &bars.full[st], 64 * j, hy,
                              bz);
      }
    });
    return;
  }

  regs_up<232>();
  const int wg = tid / 128, tw = tid % 128;
  const int warp = tw / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8
  const float sc = p.scale * kLog2e;
  const uint32_t base = smem_addr(sm);
  const uint32_t own_q = base + 2 * wg * T::kTile, own_do = own_q + T::kTile;
  const bool drel = chunk == 0;
  const int KH = p.rel.KH, KW = p.rel.KW;
  const RelRows rr = p.rel.rows(bz, hy, row0, p.N);

  float lse2[2], delta[2];  // +inf and 0 past N: P = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < p.N ? p.lse[bh * p.N + row] * kLog2e : INFINITY;
    delta[h] = row < p.N ? p.delta[bh * p.N + row] : 0.f;
  }

  // key-grid mode: the warpgroup's rel_h rows (and at D = 80 its rel_w
  // rows) staged once, the thread's rel_w columns (D = 64) in registers
  float* extra = reinterpret_cast<float*>(sm + L::kExtra);
  const float* rh_s = extra + 64 * wg * KH;
  const float* rw_s = extra + kBlockRows * KH + 64 * wg * kRwLD;
  float rw[kRwRegs ? 32 : 1], rw_acc[kGrid ? 32 : 1];
  zero(rw_acc);
  if constexpr (kGrid) {
    const float* src = p.rel.h + bz * p.rel.h_sb + hy * p.rel.h_sh;
    for (int i = tw; i < 64 * KH; i += 128) {
      const int r = min(q0 + 64 * wg + i / KH, p.N - 1);
      cp_async4(extra + 64 * wg * KH + i, src + r * p.rel.h_sn + i % KH, true);
    }
    if constexpr (!kRwRegs) {
      const float* wsrc = p.rel.w + bz * p.rel.w_sb + hy * p.rel.w_sh;
      for (int i = tw; i < 64 * 16; i += 128) {
        const int r = min(q0 + 64 * wg + i / 16, p.N - 1), c = 4 * (i % 16);
        cp_async16(extra + kBlockRows * KH + (64 * wg + i / 16) * kRwLD + c,
                   wsrc + r * p.rel.w_sn + c, true);
      }
    }
    cp_async_commit();
    if constexpr (kRwRegs) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        rw[i] = __ldg(rr.w[(i >> 1) & 1] + 8 * (i >> 2) + 2 * t + (i & 1)) * kLog2e;
    }
    cp_async_wait_all();
    named_sync(kBarWg + wg, 128);
  }

  // any KW: thread r (r + 64) of the warpgroup owns row r's drel_h (drel_w)
  // row, zeroed here; each tile's dS0 goes through the warpgroup's tile
  float* ds = extra + 64 * wg * kDsLD;
  float* bins = nullptr;
  if (!kGrid && drel) {
    const int row = q0 + 64 * wg + (tw & 63);
    if (row < p.N) {
      bins = tw < 64 ? p.drel.h_row(bz, hy, row) : p.drel.w_row(bz, hy, row);
      const int n = tw < 64 ? KH : KW;
      for (int i = 0; i < n; ++i) bins[i] = 0.f;
    }
  }

  float acc[32], acct[kAccT], s[32], dp[32];
  zero(acc);
  zero(acct);

  mbar_wait(bars.own, 0);
  int stage = 0, parity = 0;
  for (int j = 0; j < p.tiles; ++j) {
    mbar_wait(&bars.full[stage], parity);
    const uint32_t kt = base + L::kRing + stage * L::kStage, vt = kt + T::kTile;
    wg_fence();
    scores<kBlk, kTail>(s, own_q, kt);
    scores<kBlk, kTail>(dp, own_do, vt);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // the log2-domain logits
    if constexpr (kGrid) {  // the tile is key-grid row j
      float rh2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rh2[h] = rh_s[(16 * warp + g + 8 * h) * KH + j] * kLog2e;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 w;
          if constexpr (kRwRegs) {
            w = make_float2(rw[4 * jj + 2 * h], rw[4 * jj + 2 * h + 1]);
          } else {
            w = *reinterpret_cast<const float2*>(rw_s + (16 * warp + g + 8 * h) * kRwLD + 8 * jj +
                                                 2 * t);
            w.x *= kLog2e;
            w.y *= kLog2e;
          }
          s[4 * jj + 2 * h] = fmaf(s[4 * jj + 2 * h], sc, rh2[h] + w.x);
          s[4 * jj + 2 * h + 1] = fmaf(s[4 * jj + 2 * h + 1], sc, rh2[h] + w.y);
        }
    } else {
      rel_logits(*reinterpret_cast<float(*)[8][4]>(&s), rr, 64 * j, t, p.N, p.N, sc, -INFINITY,
                 KW, p.rel.inv_kw);
    }
    // dS0 = P * (dP - delta), P = 2^(logit - lse * log2(e))
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = exp2_approx(s[i] - lse2[(i >> 1) & 1]) * (dp[i] - delta[(i >> 1) & 1]);

    if (drel) {
      if constexpr (kGrid) {
        float hs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          hs[(i >> 1) & 1] += s[i];
          rw_acc[i] += s[i];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hs[h] += __shfl_xor_sync(0xffffffffu, hs[h], 1);
          hs[h] += __shfl_xor_sync(0xffffffffu, hs[h], 2);
          const int row = row0 + 8 * h;
          if (t == 0 && row < p.N) p.drel.h_row(bz, hy, row)[j] = hs[h];
        }
      } else {
        named_sync(kBarWg + wg, 128);  // the last tile's sums have read the tile
#pragma unroll
        for (int i = 0; i < 32; ++i)
          ds[(16 * warp + g + 8 * ((i >> 1) & 1)) * kDsLD + 8 * (i >> 2) + 2 * t + (i & 1)] = s[i];
        named_sync(kBarWg + wg, 128);
        if (bins != nullptr) {
          const float* x = ds + (tw & 63) * kDsLD;
          const int cols = min(64, p.N - 64 * j);
          int jh, jw;
          col_split(64 * j, p.rel.inv_kw, KW, jh, jw);
          if (tw < 64) {  // runs of one key-grid row, each added once
            float run = bins[jh];
            for (int c = 0; c < cols; ++c) {
              if (jw == KW) {
                bins[jh++] = run;
                run = bins[jh];
                jw = 0;
              }
              run += x[c];
              ++jw;
            }
            bins[jh] = run;
          } else {
            for (int c = 0; c < cols; ++c) {
              bins[jw] += x[c];
              if (++jw == KW) jw = 0;
            }
          }
        }
      }
    }

    uint32_t a[4][4];
    pack(a, s);
    wg_fence();
    times_tile<kBlk, kTail>(acc, acct, a, kt, 64 * chunk);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_regs(acct);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) settle(a[kk]);
    if (lane == 0) mbar_arrive(&bars.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }

  bf16* dqh = p.dq + bz * p.o_sb + hy * p.o_sh;
  store_bf16<64>(dqh, p.o_sn, acc, p.scale, row0, p.N, 64 * chunk, p.D, t, p.out_vec);
  if constexpr (kTail > 0)
    store_bf16<kTail>(dqh, p.o_sn, acct, p.scale, row0, p.N, 64 * kBlk, p.D, t, p.out_vec);
  if constexpr (kGrid) {
    if (drel) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.N) continue;
        float* w_row = p.drel.w_row(bz, hy, row);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          w_row[8 * jj + 2 * t] = rw_acc[4 * jj + 2 * h];
          w_row[8 * jj + 2 * t + 1] = rw_acc[4 * jj + 2 * h + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------- dK/dV walk
//
// Block (key block of 128 rows, output column chunk) of one (batch, head):
// the query tiles 0 .. tiles - 1 in order.
template <int kBlk, int kTail, bool kGrid>
__device__ __forceinline__ void dkv_walk(const BwdParams& p) {
  using T = Tiles<kBlk, kTail>;
  using L = KLayout<kBlk, kTail, kGrid>;
  constexpr int kStages = L::kStages;
  constexpr int kAccT = kTail ? kTail / 2 : 1;
  unsigned char* sm = aligned_smem();
  Bars bars(sm + L::kBars, kStages);

  const int chunk = blockIdx.x % p.chunks, kb = blockIdx.x / p.chunks;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int k0 = kBlockRows * kb;
  const int tid = threadIdx.x;
  const int KW = p.rel.KW;
  const float* relh = p.rel.h + bz * p.rel.h_sb + hy * p.rel.h_sh;
  const float* relw = p.rel.w + bz * p.rel.w_sb + hy * p.rel.w_sh;

  if (tid == 0) bars.init(kStages);
  __syncthreads();

  if (tid >= kConsumers) {
    regs_down<40>();
    if (tid >= kConsumers + 32) return;
    if (tid == kConsumers) {
      mbar_expect_tx(bars.own, 4 * T::kTile);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        tma_tile<kBlk, kTail>(sm + 2 * w * T::kTile, &p.k_map, &p.k_tail, bars.own, k0 + 64 * w,
                              hy, bz);
        tma_tile<kBlk, kTail>(sm + (2 * w + 1) * T::kTile, &p.v_map, &p.v_tail, bars.own,
                              k0 + 64 * w, hy, bz);
      }
    }
    // key-grid mode: the key-grid row of each warpgroup's keys
    const int jh0 = min(k0, p.N - 1) / KW, jh1 = min(k0 + 64, p.N - 1) / KW;
    const float* lse = p.lse + bh * p.N;
    const float* delta = p.delta + bh * p.N;
    produce<kStages>(bars, p.tiles, [&](int st, int i, int lane) {
      unsigned char* dst = sm + L::kRing + st * L::kStage;
      float* terms = reinterpret_cast<float*>(dst + L::kTermsAt);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, row = 64 * i + c;
        const bool in = row < p.N;
        terms[c] = in ? __ldg(lse + row) * kLog2e : INFINITY;
        terms[64 + c] = in ? __ldg(delta + row) : 0.f;
        if constexpr (kGrid) {
          const float* rh = relh + min(row, p.N - 1) * p.rel.h_sn;
          terms[128 + c] = __ldg(rh + jh0) * kLog2e;
          terms[192 + c] = __ldg(rh + jh1) * kLog2e;
        }
      }
      if (lane == 0) {
        mbar_expect_tx(&bars.full[st], L::kTermsAt);
        tma_tile<kBlk, kTail>(dst, &p.q_map, &p.q_tail, &bars.full[st], 64 * i, hy, bz);
        tma_tile<kBlk, kTail>(dst + T::kTile, &p.do_map, &p.do_tail, &bars.full[st], 64 * i, hy,
                              bz);
        if constexpr (kGrid) {
          tma_box(dst + L::kRelAt, &p.w_map, &bars.full[st], 0, 64 * i, hy, bz);
          tma_box(dst + L::kRelAt + kRelTile / 2, &p.w_map, &bars.full[st], 32, 64 * i, hy, bz);
        }
      }
    });
    return;
  }

  regs_up<232>();
  const int wg = tid / 128, tw = tid % 128;
  const int warp = tw / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float sc = p.scale * kLog2e;
  const uint32_t base = smem_addr(sm);
  const uint32_t own_k = base + 2 * wg * T::kTile, own_v = own_k + T::kTile;

  // key-grid mode: the thread's two keys' rel_w elements in the stage's
  // rel_w tile (two 32-column boxes, 128-byte swizzle) for query column c at
  // + c * 128 past rw_at[h][c & 1]
  int rw_at[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kw = 16 * warp + g + 8 * h;  // = jw
#pragma unroll
    for (int e = 0; e < 2; ++e)
      rw_at[h][e] = (kw >> 5) * (kRelTile / 2) + ((((kw & 31) >> 2) ^ (2 * t + e)) << 4) + 4 * (kw & 3);
  }

  float dk[32], dv[32], dkt[kAccT], dvt[kAccT], s[32], dp[32];
  zero(dk);
  zero(dv);
  zero(dkt);
  zero(dvt);

  // any KW: the warpgroup's [64 keys x 64 queries] bias tile of each query
  // tile, (rel_h + rel_w) * log2(e), made by the warpgroup in shared memory
  // (thread tw: query column tw % 64, keys 32 * (tw / 64) ..)
  float* bias_s = reinterpret_cast<float*>(sm + L::kBias) + 64 * wg * kDsLD;
  int bias_jh = 0, bias_jw = 0;
  if constexpr (!kGrid)
    col_split(min(k0 + 64 * wg + 32 * (tw / 64), p.N - 1), p.rel.inv_kw, KW, bias_jh, bias_jw);

  mbar_wait(bars.own, 0);
  int stage = 0, parity = 0;
  for (int i = 0; i < p.tiles; ++i) {
    mbar_wait(&bars.full[stage], parity);
    const uint32_t qt = base + L::kRing + stage * L::kStage, dot = qt + T::kTile;
    const unsigned char* stage_at = sm + L::kRing + stage * L::kStage;
    const float* terms = reinterpret_cast<const float*>(stage_at + L::kTermsAt);
    wg_fence();
    scores<kBlk, kTail>(s, own_k, qt);
    scores<kBlk, kTail>(dp, own_v, dot);
    wg_commit();
    if constexpr (!kGrid) {
      named_sync(kBarWg + wg, 128);  // the last tile's bias is read
      const long long q = min(64 * i + (tw & 63), p.N - 1);
      const float* hq = relh + q * p.rel.h_sn;
      const float* wq = relw + q * p.rel.w_sn;
      const int r0 = 32 * (tw / 64);
      const int last = p.N - 1 - (k0 + 64 * wg + r0);  // keys past N repeat key N - 1
      int jh = bias_jh, jw = bias_jw;
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        bias_s[(r0 + r) * kDsLD + (tw & 63)] = (__ldg(hq + jh) + __ldg(wq + jw)) * kLog2e;
        if (r < last && ++jw == KW) {
          jw = 0;
          ++jh;
        }
      }
      named_sync(kBarWg + wg, 128);
    }
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS0^T: rows the thread's keys, columns the tile's queries
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * t + e;  // the query column
        const float lse2 = terms[c], dlt = terms[64 + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = 4 * jj + 2 * h + e;
          float bias2;
          if constexpr (kGrid) {
            const float w =
                *reinterpret_cast<const float*>(stage_at + L::kRelAt + rw_at[h][e] + c * 128);
            bias2 = terms[128 + 64 * wg + c] + w * kLog2e;
          } else {
            bias2 = bias_s[(16 * warp + g + 8 * h) * kDsLD + c];
          }
          const float pv = exp2_approx(fmaf(s[idx], sc, bias2) - lse2);
          s[idx] = pv;
          dp[idx] = pv * (dp[idx] - dlt);
        }
      }

    uint32_t ph[4][4], dh[4][4];
    pack(ph, s);
    pack(dh, dp);
    wg_fence();
    times_tile<kBlk, kTail>(dv, dvt, ph, dot, 64 * chunk);
    times_tile<kBlk, kTail>(dk, dkt, dh, qt, 64 * chunk);
    wg_commit();
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dvt);
    fence_regs(dkt);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      settle(ph[kk]);
      settle(dh[kk]);
    }
    if (lane == 0) mbar_arrive(&bars.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }

  const int row0 = k0 + 64 * wg + 16 * warp + g;
  const long long off = bz * p.o_sb + hy * p.o_sh;
  store_bf16<64>(p.dk + off, p.o_sn, dk, p.scale, row0, p.N, 64 * chunk, p.D, t, p.out_vec);
  store_bf16<64>(p.dv + off, p.o_sn, dv, 1.f, row0, p.N, 64 * chunk, p.D, t, p.out_vec);
  if constexpr (kTail > 0) {
    store_bf16<kTail>(p.dk + off, p.o_sn, dkt, p.scale, row0, p.N, 64 * kBlk, p.D, t, p.out_vec);
    store_bf16<kTail>(p.dv + off, p.o_sn, dvt, 1.f, row0, p.N, 64 * kBlk, p.D, t, p.out_vec);
  }
}

// The kernels, named by walk so that a profile tells them apart.
template <int kBlk, int kTail, bool kGrid>
__global__ void __launch_bounds__(kThreads, 1)
    flash_relpos_bwd_dq(const __grid_constant__ BwdParams p) {
  dq_walk<kBlk, kTail, kGrid>(p);
}

template <int kBlk, int kTail, bool kGrid>
__global__ void __launch_bounds__(kThreads, 1)
    flash_relpos_bwd_dkv(const __grid_constant__ BwdParams p) {
  dkv_walk<kBlk, kTail, kGrid>(p);
}

// ------------------------------------------------------------- host side

template <typename Kernel>
int launch(Kernel kernel, int smem, const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.N + kBlockRows - 1) / kBlockRows * p.chunks, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The dQ walk's shared memory past its barriers: key-grid mode the rel_h
// rows (and at D = 80 the rel_w rows), any KW the two dS0 tiles.
template <int kBlk, int kTail>
int dq_smem(const BwdParams& p, bool grid) {
  const int extra = grid ? 4 * kBlockRows * (p.rel.KH + (kTail ? kRwLD : 0))
                         : 4 * kBlockRows * kDsLD;
  return QLayout<kBlk, kTail>::kExtra + extra + 1024;  // room to align the base
}

// dQ walk, then dK/dV walk, on one stream.
template <int kBlk, int kTail, bool kGrid>
int launch_walks(const BwdParams& p, cudaStream_t stream) {
  const int err = launch(flash_relpos_bwd_dq<kBlk, kTail, kGrid>, dq_smem<kBlk, kTail>(p, kGrid), p,
                         stream);
  if (err != 0) return err;
  return launch(flash_relpos_bwd_dkv<kBlk, kTail, kGrid>,
                KLayout<kBlk, kTail, kGrid>::kBytes + 1024, p, stream);
}

// The columns as kernel shapes: D <= 64 one box of 64 (zeros past D), (64,
// 80] a box and a 16-column tail, else boxes of 64 (zeros past D), the
// output in chunks of 64 columns. Key-grid mode only at D <= 80.
int by_head_dim(const BwdParams& p, bool grid, cudaStream_t s) {
  if (p.D <= 64) return grid ? launch_walks<1, 0, true>(p, s) : launch_walks<1, 0, false>(p, s);
  if (p.D <= 80) return grid ? launch_walks<1, 16, true>(p, s) : launch_walks<1, 16, false>(p, s);
  if (grid) return static_cast<int>(cudaErrorInvalidValue);
  if (p.D <= 128) return launch_walks<2, 0, false>(p, s);
  if (p.D <= 192) return launch_walks<3, 0, false>(p, s);
  return launch_walks<4, 0, false>(p, s);
}

}  // namespace

// Backward of kernel K5 in bf16: dq, dk, dv [B, H, N, D] (one set of
// strides out_*, head dim contiguous) and drel_h, drel_w (fp32, the shapes
// of rel_h and rel_w, their own strides dh_*, dw_*; every element written,
// no zero fill needed) from q, k, v, dout (each with its own strides in
// elements, head dim contiguous; every base 16-byte aligned and every
// stride a multiple of 8 elements, as TMA reads them), rel_h and rel_w (fp32,
// their own strides, last axis contiguous), and the forward's log-sum-exp
// and delta = rowsum(dout * out), fp32 [B * H, N] each. grid = 1 takes the
// key-grid mode (KW = 64, D <= 80, KH <= 128; rel_w's base 16-byte aligned
// and its strides multiples of 4 elements, as TMA reads it). Two launches
// on `stream`; returns a cudaError_t (0 = both launched;
// cudaErrorInvalidValue also when a tensor map cannot be made).
extern "C" int saicv_flash_relpos_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
    const float* lse, const float* delta, const float* rel_h, const float* rel_w, float* drel_h,
    float* drel_w, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long do_sb, long long do_sh, long long do_sn, long long out_sb, long long out_sh,
    long long out_sn, long long h_sb, long long h_sh, long long h_sn, long long w_sb,
    long long w_sh, long long w_sn, long long dh_sb, long long dh_sh, long long dh_sn,
    long long dw_sb, long long dw_sh, long long dw_sn, int B, int H, int N, int D, int KH,
    int KW, int grid, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > (1 << 20) || D < 1 || D > 256 ||
      KH < 1 || KW < 1 || static_cast<long long>(KH) * KW != N || !rel_h || !rel_w || !drel_h ||
      !drel_w || !lse || !delta || (grid && (KW != 64 || D > 80 || KH > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  const void* in[4] = {q, k, v, dout};
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, do_sb, do_sh, do_sn};
  CUtensorMap* maps[4] = {&p.q_map, &p.k_map, &p.v_map, &p.do_map};
  CUtensorMap* tails[4] = {&p.q_tail, &p.k_tail, &p.v_tail, &p.do_tail};
  for (int i = 0; i < 4; ++i) {
    if (!make_map(maps[i], in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, N, D))
      return static_cast<int>(cudaErrorInvalidValue);
    if (D > 64 && D <= 80 &&
        !make_map(tails[i], in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, N, D, 16, 64,
                  CU_TENSOR_MAP_SWIZZLE_32B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid && !make_map(&p.w_map, rel_w, w_sb, w_sh, w_sn, B, H, N, KW, 32, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = lse;
  p.delta = delta;
  p.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  p.drel = RelGrad{drel_h, drel_w, dh_sb, dh_sh, dh_sn, dw_sb, dw_sh, dw_sn};
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.o_sb = out_sb;
  p.o_sh = out_sh;
  p.o_sn = out_sn;
  p.B = B;
  p.H = H;
  p.N = N;
  p.D = D;
  p.tiles = (N + 63) / 64;
  p.chunks = D <= 80 ? 1 : (D + 63) / 64;
  const auto even = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 3u) == 0; };
  p.out_vec = D % 2 == 0 && even(dq) && even(dk) && even(dv) && out_sb % 2 == 0 &&
              out_sh % 2 == 0 && out_sn % 2 == 0;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid ? (D <= 64 ? dq_smem<1, 0>(p, true) : dq_smem<1, 16>(p, true)) > kMaxSmem : false)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(p, grid != 0, s);
}
