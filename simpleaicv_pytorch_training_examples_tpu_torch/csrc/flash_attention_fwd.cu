// Forward of the streaming (flash) attention kernels K5 and K6 in bf16, for
// Hopper (sm_90a): wgmma products on TMA-fed tiles, two consumer
// warpgroups that trade softmax and products, keys split over blocks with
// a fixed-order merge, and (K6) the key tiles of empty memory slots
// skipped.
//
// Replaces, for bf16 inputs, the TPU (Pallas) kernels of the JAX package's
// ops/pallas/flash_attention.py:
//   K5  _fwd_rel_kernel (via _flash_rel_forward, entry
//       flash_attention_relpos): SAM's decomposed rel-pos bias, the score of
//       query i and key j = jh * KW + jw gains rel_h[i, jh] + rel_w[i, jw]
//       (fp32, N = KH * KW, each term through its own strides);
//   K6  _fwd_kernel (via _flash_forward, entry flash_attention): a key bias
//       [B, Nk] (fp32, through its batch stride, shared by the heads and the
//       queries) or none; keys past Nk get -inf. The bias stays finite
//       (-1e9 on the empty memory slots of SAM2's tracker), so a row whose
//       keys are all masked averages V, as on the TPU.
// q [B, H, Nq, D], k and v [B, H, Nk, D], each read in place through a 4-D
// tensor map {D, N, H, B} with its own strides; the output is written
// through its own. Writes the fp32 log-sum-exp of every query row in the
// natural log, which K5's backward (flash_relpos_bwd.cu) and K6's
// (flash_keybias_bwd.cu) read. fp32 inputs keep flash_attention.cu's FMA
// forward.
//
// Math, as the TPU kernels and the port's first forward: fp32 scores, each
// the log2-domain logit s * scale * log2(e) + bias * log2(e) as it leaves
// the tensor cores; one walk over the keys with an online row max and sum
// in fp32; P = 2^(logit - max) rounded to bf16 for P.V, accumulated in
// fp32, the output divided by the fp32 sum at the end; lse = (max +
// log2(sum)) * ln 2. With a gradient to come (K6, p_residual) P.V also
// multiplies P's bf16 residual (P - bf16(P)), a second register-A product,
// so that the output carries P at fp32 precision (with P rounded alone,
// SAM2's gradient check put 90 parameters off the plain path's floor).
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): K5 at SAM-B's
// global blocks ([8, 12, 4096, 64]) is 4 * B * H * N^2 * D = 412 GFLOP =
// 0.417 ms of products against 201 MB of q, k, v, out and 201 MB of rel
// terms (0.12 ms): bound by operations. Its 1.6e9 exponentials take about
// as long again on the special-function units (16 a clock an SM), so a
// tile's softmax has to run beside another tile's products. K6 at SAM2's
// memory cross-attention (B = H = 1, Nq = 4096, Nk = 28,736, D = 256) is
// 120.5 GFLOP over every key = 0.122 ms against 34 MB: bound by operations
// too; at frame 1, 6 of its 7 memory slots are empty.
//
// Design.
//   - A block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each and a producer warpgroup (384 threads) of
//     which one warp works and which gives its registers to the consumers
//     (setmaxnreg 40 / 232; ptxas reports the 168 of the launch bound, no
//     spill). The producer warp loads both warpgroups' Q tiles once, then
//     streams K and V tiles of 64 keys through rings of their own, with
//     full and empty mbarriers, so that a K stage is free again once its
//     scores are done and a V stage once its P.V is: 4 stages each at D <=
//     80 (2 left the walk waiting for tiles at Hiera's and SAM-B's global
//     blocks), 3 at D <= 128, 2 above.
//   - Tiles are 64 rows x 64 columns of bf16 in the 128-byte swizzle that
//     TMA writes and wgmma reads, D / 64 of them across (D = 56 as 64 with
//     the tensor map's zero fill, 160 as 192); D in (64, 80] (SAM-H) takes
//     its columns 64-79 in a box of 16 columns in the 32-byte swizzle, one
//     more k-step and an n = 16 P.V, as short_attention_fwd.cu does.
//   - S = Q.K^T runs over the whole head dim, so no part of it is computed
//     twice, D = 256 included. Up to D = 128 Q's A fragments stay in
//     registers (a register-A wgmma, K read K-major: only K's tile comes
//     from shared memory, where an SS product of 64 keys would read as many
//     bytes a clock as shared memory gives); above, an SS wgmma. P.V is a
//     register-A wgmma (P's accumulator layout is the A operand's), n = D
//     rounded up, V read MN-major through the descriptor's transpose bit. A
//     warpgroup holds its 64 x D fp32 output (128 registers a thread at D =
//     256) beside S (32) and the bf16 P of the last tile (16, and 16 for
//     its residual).
//   - Overlap. A warpgroup issues tile j's scores and tile j - 1's P.V
//     together, then runs tile j's softmax while P.V runs; the two
//     warpgroups take turns at issuing (two named barriers), so that one's
//     softmax runs beside the other's products. At D = 256 with P's
//     residual, or K5's rel terms, the registers of two tiles would not fit
//     beside the output: there P.V follows the softmax, and only the other
//     warpgroup's work overlaps it.
//   - Split keys. Where the query blocks of all heads are fewer than the
//     SMs (SAM2's memory attention: B = H = 1, 32 blocks), block (query
//     block, split s) walks the key tiles j with j mod S = s (interleaved,
//     so that empty memory slots spread evenly over the splits) and writes
//     its unnormalised fp32 output, row max and row sum; a merge kernel
//     combines the splits in the order s = 0 ... S - 1 and writes the bf16
//     output and the log-sum-exp. No atomics: two runs give the same bits.
//   - Empty slots (K6). The bias is shared by the heads and the queries, so
//     whether a key tile is empty is known for a whole batch row before the
//     walk. A tile whose every key has bias <= -5e8 (or lies past Nk) is
//     skipped when the batch row has a key above -5e8: once a real key has
//     set the row max its P is exactly 0, and where such a tile would come
//     first the real key's rescaling multiplies what it added by exactly 0,
//     so the output and lse are the same bit for bit. A row with no real key
//     keeps every tile (and averages V). The block first looks for a real
//     key (384 threads, 8 keys each a round, stopping at the first round
//     that finds one); the producer then decides 32 tiles at a time, a lane
//     a tile, by a ballot, as flash_keybias_bwd.cu does, with the same
//     thresholds. It writes each kept tile's bias * log2(e) beside the K
//     tile in its stage.
//   - K5's rel terms. Where KW is a multiple of 64 (SAM: KW = 64) a key tile
//     lies in one row jh of the key grid: a thread's rel_w values of its 16
//     key columns stay in registers (reloaded only when the tile's column
//     offset changes: for KW = 64 never), and rel_h[i, jh] is one value a
//     row a tile, staged once for the block's rows (128 x KH fp32, 32 KB at
//     KH = 64) and folded into the max that is subtracted instead of being
//     added to each score. Other KW (and D > 128) read both terms of every
//     score through L1, as the first forward did.
//   Shared memory: 10 tiles of 8 KB at D = 64 (+ 32 KB of rel_h rows for
//   K5), 10 of 10 KB at D = 80, 8 of 16 KB at D = 128, 6 of 32 KB at D =
//   256.

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
constexpr int kBlockRows = 128;             // query rows a block
constexpr int kBox = 64 * 64 * 2;           // bytes of one 64 x 64 bf16 box
constexpr float kMaskedBias = -5e8f;        // a key with a bias at or below: masked

// named barriers (0 is __syncthreads)
constexpr int kBarTurn = 1;  // + warpgroup: its turn to issue products
constexpr int kBarWg = 3;    // + warpgroup: within one warpgroup

// What the scores gain: K6's key bias; K5's rel-pos terms with each key
// tile in one row of the key grid (KW a multiple of 64), or any KW.
enum Mode { kKeyBias, kRelGrid, kRelAny };

struct FwdParams {
  CUtensorMap q_map, k_map, v_map;     // boxes of 64 x 64, 128-byte swizzle
  CUtensorMap q_tail, k_tail, v_tail;  // D in (64, 80]: boxes of 16 x 64, 32-byte swizzle
  bf16* o;
  long long o_sb, o_sh, o_sn;
  float* lse;                          // [B * H, Nq]
  float* part;                         // splits > 1: [S][B * H][Nq][Dp] unnormalised output
  float* stats;                        // splits > 1: [2][S][B * H][Nq] row max (log2), row sum
  const float* bias;                   // K6: [B, Nk] or null
  long long bias_sb;
  RelPos rel;                          // K5: Nq = Nk
  int B, H, Nq, Nk, D;
  int k_tiles, splits, out_vec;
  int kw_tiles;                        // kRelGrid: KW / 64
  float scale;
};

// Byte offsets in a block's dynamic shared memory (1024-byte aligned): the
// two Q tiles, the K and V rings (as many stages as leave room for K5's rel
// rows at D = 128: 4 at D <= 80, 3 at 128, 2 above), each K stage's bias
// terms, the barriers and (K5) the staged rel_h rows.
template <int kBlk, int kTail>
struct Layout {
  static constexpr int kStages = kBlk == 1 ? 4 : kBlk == 2 ? 3 : 2;
  static constexpr int kTile = kBlk * kBox + (kTail ? 64 * 32 : 0);  // a 64-row tile
  static constexpr int kQ = 0;  // each warpgroup's Q tile
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kTerms = kV + kStages * kTile;  // [kStages][64] bias * log2(e)
  static constexpr int kBars = kTerms + kStages * 64 * 4;
  static constexpr int kRel = kBars + 256;             // K5: rel_h rows [128][KH]
};

template <int kStages>
struct Bars {
  uint64_t* q;
  uint64_t *kfull, *kempty, *vfull, *vempty;
  volatile int* tile;  // the key tile of each K stage; -1 ends the walk

  __device__ __forceinline__ explicit Bars(unsigned char* at) {
    q = reinterpret_cast<uint64_t*>(at);
    kfull = q + 1;
    kempty = kfull + kStages;
    vfull = kempty + kStages;
    vempty = vfull + kStages;
    tile = reinterpret_cast<volatile int*>(vempty + kStages);
  }
  __device__ __forceinline__ void init() {
    mbar_init(q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 32);  // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(&kempty[s], kConsumerWarps);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], kConsumerWarps);
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

// ------------------------------------------------------------- tile math
//
// Accumulator layout of a 64 x N product in a warpgroup: warp w holds rows
// 16w.. 16w+15; register i of a thread (lane = 4g + t) is row 16w + g + 8 *
// ((i >> 1) & 1), column 8 * (i >> 2) + 2t + (i & 1).

// s (64 x 64) = Q (64 x D) . K (64 x D)^T over the whole head dim, both
// K-major; committed, not waited for.
template <int kBlk, int kTail>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q, uint32_t k) {
  wg_fence();
#pragma unroll
  for (int c = 0; c < kBlk; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64, 0>(s, sw128_desc(q + c * kBox + 32 * kk, 16),
                      sw128_desc(k + c * kBox + 32 * kk, 16), c | kk);
  if constexpr (kTail > 0)
    wgmma_ss<64, 0>(s, sw32_desc(q + kBlk * kBox), sw32_desc(k + kBlk * kBox), 1);
  wg_commit();
}

// The same with Q's A fragments in registers (qf: a k-step each), K read
// K-major: only K's tile is read from shared memory.
template <int kBlk, int kTail>
__device__ __forceinline__ void scores(float (&s)[32], const uint32_t (&qf)[4 * kBlk + 1][4],
                                       uint32_t k) {
  wg_fence();
#pragma unroll
  for (int c = 0; c < kBlk; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_kmajor(s, qf[4 * c + kk], sw128_desc(k + c * kBox + 32 * kk, 16), c | kk);
  if constexpr (kTail > 0) wgmma_rs_kmajor(s, qf[4 * kBlk], sw32_desc(k + kBlk * kBox), 1);
  wg_commit();
}

// A warpgroup's Q tile (64 rows, swizzled as TMA wrote it) as the A
// fragments of the k-steps: a[0] row g, columns 2t, 2t + 1 of the k-step;
// a[1] row g + 8; a[2], a[3] the same rows 8 columns on.
template <int kBlk, int kTail>
__device__ __forceinline__ void q_fragments(uint32_t (&qf)[4 * kBlk + 1][4],
                                            const unsigned char* q, int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 16 * warp + g + 8 * (r & 1), hi = r >> 1;
#pragma unroll
    for (int c = 0; c < kBlk; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 128-byte swizzle: 16-byte chunk ^ row % 8
        qf[4 * c + kk][r] = *reinterpret_cast<const uint32_t*>(
            q + c * kBox + row * 128 + (((2 * kk + hi) ^ (row & 7)) << 4) + 4 * t);
    // 32-byte swizzle: 16-byte chunk ^ (row / 4) % 2
    qf[4 * kBlk][r] = kTail ? *reinterpret_cast<const uint32_t*>(
                                  q + kBlk * kBox + row * 32 + ((hi ^ ((row >> 2) & 1)) << 4) + 4 * t)
                            : 0u;
  }
#pragma unroll
  for (int i = 0; i < 4 * kBlk + 1; ++i) settle(qf[i]);
}

// o (64 x 64 kBlk) and ot (64 x kTail) += P (64 x 64, bf16 registers) . V
// (64 x D, MN-major), and P's residual likewise; committed, not waited for.
template <int kBlk, int kTail, bool kResidual>
__device__ __forceinline__ void times_v(float (&o)[32 * kBlk], float (&ot)[kTail ? kTail / 2 : 1],
                                        const uint32_t (&ph)[4][4],
                                        const uint32_t (&pl)[kResidual ? 4 : 1][4], uint32_t v) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<64 * kBlk>(o, ph[kk], sw128_desc(v + 16 * 128 * kk, kBox), 1);
    if constexpr (kTail == 16) wgmma_rs<16>(ot, ph[kk], sw32_desc(v + kBlk * kBox + 16 * 32 * kk), 1);
    if constexpr (kResidual) {
      wgmma_rs<64 * kBlk>(o, pl[kk], sw128_desc(v + 16 * 128 * kk, kBox), 1);
      if constexpr (kTail == 16)
        wgmma_rs<16>(ot, pl[kk], sw32_desc(v + kBlk * kBox + 16 * 32 * kk), 1);
    }
  }
  wg_commit();
}

// Rows row0 (+8) of a warpgroup's 64 x NH fp32 accumulators, columns
// col0.., into part (row stride Dp).
template <int NH>
__device__ __forceinline__ void store_f32(float* part, int Dp, const float (&acc)[NH / 2],
                                          int row0, int N, int col0, int t) {
#pragma unroll
  for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= N) continue;
      *reinterpret_cast<float2*>(part + static_cast<long long>(row) * Dp + col0 + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
}

// ------------------------------------------------------------- skip rule

__device__ __forceinline__ bool key_masked(const float* bias, int key, int Nk) {
  return key >= Nk || __ldg(bias + key) <= kMaskedBias;
}

// A lane's test of one key tile.
__device__ __forceinline__ bool key_tile_masked(const float* bias, int tile, int Nk) {
  bool masked = true;
#pragma unroll 16
  for (int i = 0; i < 64; ++i) masked &= key_masked(bias, 64 * tile + i, Nk);
  return masked;
}

// Whether the batch row's bias has a key above kMaskedBias: every thread of
// the block reads 8 keys a round, and the rounds stop at the first that
// finds one (the result is the block's).
__device__ __forceinline__ bool row_has_real_key(const float* bias, int Nk) {
  for (int base = 0; base < Nk; base += 8 * kThreads) {
    bool real = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = base + i * kThreads + static_cast<int>(threadIdx.x);
      real |= key < Nk && __ldg(bias + key) > kMaskedBias;
    }
    if (__syncthreads_or(real)) return true;
  }
  return false;
}

// ------------------------------------------------------------- the kernel

template <int kBlk, int kTail, int kMode, bool kResidual>
__device__ __forceinline__ void flash_fwd(const FwdParams& p) {
  using L = Layout<kBlk, kTail>;
  constexpr int kStages = L::kStages;
  constexpr int kO = 32 * kBlk;  // output registers, columns 0 .. 64 kBlk - 1
  constexpr int kOT = kTail ? kTail / 2 : 1;
  // a warpgroup issues tile j's scores with tile j - 1's P.V, but where the
  // output takes 128 registers and P's residual or K5's rel terms add to
  // them, P.V follows the softmax (the other warpgroup's work overlaps)
  constexpr bool kOverlap = kBlk < 4 || (kMode == kKeyBias && !kResidual);
  unsigned char* sm = aligned_smem();
  Bars<kStages> bars(sm + L::kBars);
  float* terms = reinterpret_cast<float*>(sm + L::kTerms);

  const int S = p.splits;
  const int qb = blockIdx.x / S, split = blockIdx.x % S;
  const int hy = blockIdx.y, bz = blockIdx.z;
  const long long bh = static_cast<long long>(bz) * p.H + hy;
  const int q0 = kBlockRows * qb;
  const int tid = threadIdx.x;
  const float* bias = kMode == kKeyBias && p.bias ? p.bias + bz * p.bias_sb : nullptr;

  if (tid == 0) bars.init();
  __syncthreads();
  if (tid == kConsumers) {  // both warpgroups' Q tiles
    mbar_expect_tx(bars.q, 2 * L::kTile);
#pragma unroll
    for (int w = 0; w < 2; ++w)
      tma_tile<kBlk, kTail>(sm + L::kQ + w * L::kTile, &p.q_map, &p.q_tail, bars.q, q0 + 64 * w,
                            hy, bz);
  }
  // K6: empty key tiles are skipped only where the row has a real key
  const bool skip = bias != nullptr && row_has_real_key(bias, p.Nk);

  if (tid >= kConsumers) {  // the producer warpgroup; its first warp loads
    regs_down<40>();
    if (tid >= kConsumers + 32) return;
    const int lane = tid % 32;
    int st = 0, parity = 1;  // the rings start empty
    auto push = [&](int j) {
      if (lane == 0) mbar_wait(&bars.kempty[st], parity);
      __syncwarp();
      if (kMode == kKeyBias && j >= 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = 64 * j + lane + 32 * h;
          terms[st * 64 + lane + 32 * h] =
              key >= p.Nk ? -INFINITY : bias ? __ldg(bias + key) * kLog2e : 0.f;
        }
      }
      if (lane == 0) {
        bars.tile[st] = j;
        if (j >= 0) {
          mbar_expect_tx(&bars.kfull[st], L::kTile);
          tma_tile<kBlk, kTail>(sm + L::kK + st * L::kTile, &p.k_map, &p.k_tail, &bars.kfull[st],
                                64 * j, hy, bz);
          mbar_wait(&bars.vempty[st], parity);
          mbar_expect_tx(&bars.vfull[st], L::kTile);
          tma_tile<kBlk, kTail>(sm + L::kV + st * L::kTile, &p.v_map, &p.v_tail, &bars.vfull[st],
                                64 * j, hy, bz);
        } else {
          mbar_arrive(&bars.kfull[st]);
        }
      } else {
        mbar_arrive(&bars.kfull[st]);
      }
      if (++st == kStages) {
        st = 0;
        parity ^= 1;
      }
    };
    for (int base = split; base < p.k_tiles; base += 32 * S) {
      const int j = base + lane * S;
      unsigned kept = __ballot_sync(0xffffffffu, j < p.k_tiles &&
                                                     !(skip && key_tile_masked(bias, j, p.Nk)));
      while (kept) {
        const int l = __ffs(kept) - 1;
        kept &= kept - 1;
        push(base + l * S);
      }
    }
    push(-1);
    return;
  }

  regs_up<232>();
  const int wg = tid / 128, tw = tid % 128;
  const int warp = tw / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8
  const float sc = p.scale * kLog2e;
  const uint32_t base = smem_addr(sm);
  const uint32_t qa = base + L::kQ + wg * L::kTile;

  // K5 with key-grid rows: this warpgroup's rel_h rows staged once, the
  // thread's rel_w columns in registers
  const float* rh_s = reinterpret_cast<const float*>(sm + L::kRel) + (64 * wg) * p.rel.KH;
  float rw[kMode == kRelGrid ? 32 : 1];
  int cached_cw0 = -1;
  RelRows rr{};
  if constexpr (kMode != kKeyBias) rr = p.rel.rows(bz, hy, row0, p.Nq);
  if constexpr (kMode == kRelGrid) {
    float* dst = reinterpret_cast<float*>(sm + L::kRel) + (64 * wg) * p.rel.KH;
    const float* src = p.rel.h + bz * p.rel.h_sb + hy * p.rel.h_sh;
    const int KH = p.rel.KH;
    for (int i = tw; i < 64 * KH; i += 128) {
      const int r = min(q0 + 64 * wg + i / KH, p.Nq - 1);
      cp_async4(dst + i, src + r * p.rel.h_sn + i % KH, true);
    }
    cp_async_commit();
    cp_async_wait_all();
    named_sync(kBarWg + wg, 128);
  }

  float o[kO], ot[kOT];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kOT; ++i) ot[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the logits (log2 domain)
  float l[2] = {0.f, 0.f};              // running row sum, the thread's share
  float alpha[2];
  uint32_t ph[4][4], pl[kResidual ? 4 : 1][4];  // bf16 P (and residual) of the last tile

  // tile j's logits from its raw scores in s, the online max and sum, P in
  // s; alpha: the factor of what came before
  auto softmax = [&](int j, int kst) {
    float shift[2] = {0.f, 0.f};  // kRelGrid: the rows' rel_h, kept out of each score
    if constexpr (kMode == kKeyBias) {
      const float* tb = terms + kst * 64 + 2 * t;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 b = *reinterpret_cast<const float2*>(tb + 8 * jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * jj + e] = fmaf(s[4 * jj + e], sc, e & 1 ? b.y : b.x);
      }
    } else if constexpr (kMode == kRelGrid) {
      const int jh = j / p.kw_tiles;
      const int cw0 = (j - jh * p.kw_tiles) * 64;
      if (cw0 != cached_cw0) {
        cached_cw0 = cw0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              rw[16 * h + 2 * jj + e] = __ldg(rr.w[h] + cw0 + 8 * jj + 2 * t + e) * kLog2e;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) shift[h] = rh_s[(16 * warp + g + 8 * h) * p.rel.KH + jh] * kLog2e;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = fmaf(s[i], sc, rw[16 * ((i >> 1) & 1) + 2 * (i >> 2) + (i & 1)]);
    } else {
      rel_logits(*reinterpret_cast<float(*)[8][4]>(&s), rr, 64 * j, t, p.Nk, p.Nk, sc, -INFINITY,
                 p.rel.KW, p.rel.inv_kw);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mnew = fmaxf(m[h], mx[h] + shift[h]);
      alpha[h] = exp2_approx(m[h] - mnew);
      m[h] = mnew;
      shift[h] = mnew - shift[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2_approx(s[i] - shift[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
  };
  // P (and its residual) as the A fragments of the 16-key k-steps
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ph[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        if constexpr (kResidual) pl[kk][r] = pack_bf16_residual(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      settle(ph[kk]);
      if constexpr (kResidual) settle(pl[kk]);
    }
  };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  // the output times alpha; K6 skips it where no row of the warp raised its
  // max (a factor of exactly 1), K5 does not (its rel terms raise the max
  // more often, and the vote cost more than it saved)
  auto rescale = [&]() {
    if (kMode != kKeyBias || __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < kOT; ++i) ot[i] *= alpha[(i >> 1) & 1];
    }
  };
  auto pv_done = [&]() {
    wg_wait_all();
    fence_regs(o);
    fence_regs(ot);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      settle(ph[kk]);
      if constexpr (kResidual) settle(pl[kk]);
    }
  };
  // Turns: each issue of products waits for this warpgroup's turn and hands
  // the turn to the other; warpgroup 1 hands it over once before its first,
  // and warpgroup 0 takes it once after its last, so that every arrive meets
  // a wait.
  auto turn = [&]() { named_sync(kBarTurn + wg, 256); };
  auto hand_over = [&]() { named_arrive(kBarTurn + 1 - wg, 256); };
  auto next = [&](int& st, int& par) {
    if (++st == kStages) {
      st = 0;
      par ^= 1;
    }
  };

  mbar_wait(bars.q, 0);
  // up to D = 128 Q's fragments stay in registers (S reads only K's tile
  // from shared memory); past it they would not fit beside the output
  constexpr bool kQRegs = kBlk <= 2;
  uint32_t qf[kQRegs ? 4 * kBlk + 1 : 1][4];
  if constexpr (kQRegs) q_fragments<kBlk, kTail>(qf, sm + L::kQ + wg * L::kTile, warp, g, t);
  auto issue_scores = [&](uint32_t kt) {
    if constexpr (kQRegs)
      scores<kBlk, kTail>(s, qf, kt);
    else
      scores<kBlk, kTail>(s, qa, kt);
  };
  int kst = 0, kpar = 0, vst = 0, vpar = 0;
  mbar_wait(&bars.kfull[0], 0);
  int j = bars.tile[0];
  if (j >= 0) {
    if (wg == 1) named_arrive(kBarTurn, 256);
    if constexpr (kOverlap) {
      turn();
      issue_scores(base + L::kK);
      hand_over();
      wg_wait_all();
      fence_regs(s);
      softmax(j, 0);
      release(&bars.kempty[0]);
      next(kst, kpar);
      pack();
      for (;;) {
        mbar_wait(&bars.kfull[kst], kpar);
        j = bars.tile[kst];
        if (j < 0) break;
        turn();
        issue_scores(base + L::kK + kst * L::kTile);
        mbar_wait(&bars.vfull[vst], vpar);
        times_v<kBlk, kTail, kResidual>(o, ot, ph, pl, base + L::kV + vst * L::kTile);
        hand_over();
        wg_wait_one();  // the scores
        fence_regs(s);
        softmax(j, kst);
        release(&bars.kempty[kst]);
        next(kst, kpar);
        pv_done();  // the last tile's P.V
        release(&bars.vempty[vst]);
        next(vst, vpar);
        rescale();
        pack();
      }
      turn();
      mbar_wait(&bars.vfull[vst], vpar);
      times_v<kBlk, kTail, kResidual>(o, ot, ph, pl, base + L::kV + vst * L::kTile);
      hand_over();
      pv_done();
    } else {
      for (;;) {
        turn();
        issue_scores(base + L::kK + kst * L::kTile);
        hand_over();
        wg_wait_all();
        fence_regs(s);
        softmax(j, kst);
        release(&bars.kempty[kst]);
        next(kst, kpar);
        rescale();
        pack();
        mbar_wait(&bars.vfull[vst], vpar);
        turn();
        times_v<kBlk, kTail, kResidual>(o, ot, ph, pl, base + L::kV + vst * L::kTile);
        hand_over();
        pv_done();
        release(&bars.vempty[vst]);
        next(vst, vpar);
        mbar_wait(&bars.kfull[kst], kpar);
        j = bars.tile[kst];
        if (j < 0) break;
      }
    }
    if (wg == 0) named_sync(kBarTurn, 256);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const long long rows = static_cast<long long>(p.B) * p.H * p.Nq;
  if (S == 1) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= inv[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < kOT; ++i) ot[i] *= inv[(i >> 1) & 1];
    bf16* oh = p.o + bz * p.o_sb + hy * p.o_sh;
    store_bf16<64 * kBlk>(oh, p.o_sn, o, 1.f, row0, p.Nq, 0, p.D, t, p.out_vec);
    if constexpr (kTail > 0)
      store_bf16<kTail>(oh, p.o_sn, ot, 1.f, row0, p.Nq, 64 * kBlk, p.D, t, p.out_vec);
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < p.Nq) p.lse[bh * p.Nq + row] = (m[h] + __log2f(l[h])) * kLn2;
      }
    }
  } else {
    constexpr int Dp = 64 * kBlk + kTail;
    const long long at = (split * static_cast<long long>(p.B) * p.H + bh) * p.Nq;
    float* part = p.part + at * Dp;
    store_f32<64 * kBlk>(part, Dp, o, row0, p.Nq, 0, t);
    if constexpr (kTail > 0) store_f32<kTail>(part, Dp, ot, row0, p.Nq, 64 * kBlk, t);
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < p.Nq) {
          p.stats[at + row] = m[h];
          p.stats[S * rows + at + row] = l[h];
        }
      }
    }
  }
}

// The forward kernels, named by entry so that a profile tells K5 from K6.
template <int kBlk, int kTail, bool kResidual>
__global__ void __launch_bounds__(kThreads, 1)
    flash_keybias_fwd(const __grid_constant__ FwdParams p) {
  flash_fwd<kBlk, kTail, kKeyBias, kResidual>(p);
}

template <int kBlk, int kTail, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    flash_relpos_fwd(const __grid_constant__ FwdParams p) {
  flash_fwd<kBlk, kTail, kMode, false>(p);
}

// The splits' merge, in the order s = 0 ... S - 1: out[b, h, row, col] =
// bf16(sum_s w_s part_s / sum_s w_s l_s), w_s = 2^(m_s - max_s m_s) (0 for a
// split that walked no tile), and lse[b * H + h, row]; one thread an
// element.
__global__ void __launch_bounds__(256)
    flash_fwd_merge(const float* part, const float* stats, int S, long long rows, int H, int Nq,
                    int D, int Dp, bf16* out, long long sb, long long sh, long long sn, float* lse,
                    long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = static_cast<int>(idx % D);
  const long long rowg = idx / D;  // (b * H + h) * Nq + row
  float mt = -INFINITY;
  for (int s = 0; s < S; ++s) mt = fmaxf(mt, stats[s * rows + rowg]);
  float lt = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ls = stats[(S + s) * rows + rowg];
    if (ls > 0.f) {
      const float w = exp2_approx(stats[s * rows + rowg] - mt);
      lt += w * ls;
      acc += w * part[(s * rows + rowg) * Dp + col];
    }
  }
  const int row = static_cast<int>(rowg % Nq);
  const long long bh = rowg / Nq;
  out[(bh / H) * sb + (bh % H) * sh + row * sn + col] = __float2bfloat16_rn(acc / lt);
  if (col == 0) lse[rowg] = (mt + __log2f(lt)) * kLn2;
}

// ------------------------------------------------------------- host side

template <typename Kernel>
int launch(Kernel kernel, int smem, const FwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Nq + kBlockRows - 1) / kBlockRows * p.splits, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const int Dp = p.D <= 64 ? 64 : p.D <= 80 ? 80 : (p.D + 63) / 64 * 64;
  const long long rows = static_cast<long long>(p.B) * p.H * p.Nq;
  const long long total = rows * p.D;
  flash_fwd_merge<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      p.part, p.stats, p.splits, rows, p.H, p.Nq, p.D, Dp, p.o, p.o_sb, p.o_sh, p.o_sn, p.lse,
      total);
  return static_cast<int>(cudaGetLastError());
}

template <int kBlk, int kTail>
int smem_bytes(int rel_rows_bytes) {
  return Layout<kBlk, kTail>::kRel + rel_rows_bytes + 1024;  // room to align the base
}

template <int kBlk, int kTail>
int launch_keybias(const FwdParams& p, int residual, cudaStream_t stream) {
  const int smem = smem_bytes<kBlk, kTail>(0);
  return residual ? launch(flash_keybias_fwd<kBlk, kTail, true>, smem, p, stream)
                  : launch(flash_keybias_fwd<kBlk, kTail, false>, smem, p, stream);
}

template <int kBlk, int kTail>
int launch_relpos(FwdParams& p, cudaStream_t stream) {
  if constexpr (kBlk <= 2) {  // past D = 128 rel_w's registers would not fit beside the output
    constexpr int kMaxSmem = 227 * 1024;
    const int grid_smem = smem_bytes<kBlk, kTail>(kBlockRows * p.rel.KH * 4);
    if (p.rel.KW % 64 == 0 && grid_smem <= kMaxSmem) {
      p.kw_tiles = p.rel.KW / 64;
      return launch(flash_relpos_fwd<kBlk, kTail, kRelGrid>, grid_smem, p, stream);
    }
  }
  return launch(flash_relpos_fwd<kBlk, kTail, kRelAny>, smem_bytes<kBlk, kTail>(0), p, stream);
}

// The columns as kernel shapes: D <= 64 one box of 64 (zeros past D), (64,
// 80] a box and a 16-column tail, else boxes of 64 (zeros past D).
int keybias_by_head_dim(const FwdParams& p, int residual, cudaStream_t s) {
  if (p.D <= 64) return launch_keybias<1, 0>(p, residual, s);
  if (p.D <= 80) return launch_keybias<1, 16>(p, residual, s);
  if (p.D <= 128) return launch_keybias<2, 0>(p, residual, s);
  if (p.D <= 192) return launch_keybias<3, 0>(p, residual, s);
  return launch_keybias<4, 0>(p, residual, s);
}

int relpos_by_head_dim(FwdParams& p, cudaStream_t s) {
  if (p.D <= 64) return launch_relpos<1, 0>(p, s);
  if (p.D <= 80) return launch_relpos<1, 16>(p, s);
  if (p.D <= 128) return launch_relpos<2, 0>(p, s);
  if (p.D <= 192) return launch_relpos<3, 0>(p, s);
  return launch_relpos<4, 0>(p, s);
}

// Maps and the rest of a launch's parameters; false where an operand
// cannot be read through a tensor map.
bool prepare(FwdParams& p, const void* q, const void* k, const void* v, void* o, float* lse,
             float* part, float* stats, const long long (&st)[12], int B, int H, int Nq, int Nk,
             int D, int splits, float scale) {
  const void* in[3] = {q, k, v};
  const int rows[3] = {Nq, Nk, Nk};
  CUtensorMap* maps[3] = {&p.q_map, &p.k_map, &p.v_map};
  CUtensorMap* tails[3] = {&p.q_tail, &p.k_tail, &p.v_tail};
  for (int i = 0; i < 3; ++i) {
    if (!make_map(maps[i], in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, rows[i], D))
      return false;
    if (D > 64 && D <= 80 &&
        !make_map(tails[i], in[i], st[3 * i], st[3 * i + 1], st[3 * i + 2], B, H, rows[i], D, 16,
                  64, CU_TENSOR_MAP_SWIZZLE_32B))
      return false;
  }
  p.o = static_cast<bf16*>(o);
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_sn = st[11];
  p.lse = lse;
  p.part = part;
  p.stats = stats;
  p.B = B;
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.D = D;
  p.k_tiles = (Nk + 63) / 64;
  p.splits = splits;
  p.out_vec = (reinterpret_cast<uintptr_t>(o) & 3u) == 0 && D % 2 == 0 && p.o_sb % 2 == 0 &&
              p.o_sh % 2 == 0 && p.o_sn % 2 == 0;
  p.scale = scale;
  return true;
}

}  // namespace

// Plain C entry points, loaded with ctypes. q, k, v and the output are bf16
// device pointers, each with its own (batch, head, row) strides in elements
// and a contiguous head dim; q, k and v must be readable by TMA (16-byte
// aligned bases, strides multiples of 8 elements on axes longer than 1:
// the wrapper copies an operand that is not). lse: fp32 [B * H, Nq].
// splits: the key splits (1: none); for splits > 1 the caller gives the
// scratch part fp32 [splits, B * H, Nq, Dp] (Dp = D rounded up to 64, 80,
// 128, 192 or 256) and stats fp32 [2, splits, B * H, Nq]. Launch on
// `stream` (the merge too) and return a cudaError_t (0 = launched;
// cudaErrorInvalidValue for a shape or operand the kernel cannot take).

// K6: bias, the fp32 key bias [B, Nk] (batch stride bias_sb, keys
// contiguous) or null; p_residual: 1 when a gradient will follow.
extern "C" int saicv_flash_keybias_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse, const float* bias,
    float* part, float* stats, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long out_sb, long long out_sh, long long out_sn, long long bias_sb, int B, int H, int Nq,
    int Nk, int D, int splits, float scale, int p_residual, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Nq < 1 || Nq > (1 << 24) || Nk < 1 ||
      Nk > (1 << 24) || D < 1 || D > 256 || !lse || splits < 1 ||
      (splits > 1 && (!part || !stats)))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, out_sb, out_sh, out_sn};
  if (!prepare(p, q, k, v, o, lse, part, stats, st, B, H, Nq, Nk, D, splits, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.bias = bias;
  p.bias_sb = bias_sb;
  return keybias_by_head_dim(p, p_residual, static_cast<cudaStream_t>(stream));
}

// K5: the score of query i and key j gains rel_h[i, j / KW] + rel_w[i, j %
// KW] (fp32, N = KH * KW, each with its own (batch, head, row) strides and a
// contiguous last axis).
extern "C" int saicv_flash_relpos_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse, const float* rel_h,
    const float* rel_w, float* part, float* stats, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long out_sb, long long out_sh, long long out_sn, long long h_sb,
    long long h_sh, long long h_sn, long long w_sb, long long w_sh, long long w_sn, int B, int H,
    int N, int D, int KH, int KW, int splits, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || N > (1 << 20) || D < 1 || D > 256 ||
      KH < 1 || KW < 1 || static_cast<long long>(KH) * KW != N || !rel_h || !rel_w || !lse ||
      splits < 1 || (splits > 1 && (!part || !stats)))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, out_sb, out_sh, out_sn};
  if (!prepare(p, q, k, v, o, lse, part, stats, st, B, H, N, N, D, splits, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.rel = RelPos{rel_h, rel_w, h_sb, h_sh, h_sn, w_sb, w_sh, w_sn, KH, KW, 1.f / KW};
  return relpos_by_head_dim(p, static_cast<cudaStream_t>(stream));
}
